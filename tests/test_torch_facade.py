# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's collective facade against ``bluefog_tpu``'s on the JAX
package's 8-device CPU mesh, same numpy inputs through both.

Tolerances: the exact ops agree within ``1e-6 * max|want|`` absolutely
(sums may be taken in another order); the int8/int4 ``neighbor_allgather``
and the bf16 one are bitwise equal; the quantized ``neighbor_allreduce``
agrees within ``1e-6 * max|want|`` too (the two differ only where XLA:CPU
contracts a product and a sum into one rounding). Plans are identical:
perms, rounds and receive weights."""

import numpy as np
import pytest
import torch

import bluefog_tpu as bf
from bluefog_tpu import topology as tu
from bluefog_tpu.collective import plan as jplan
import bluefog_tpu_torch as bft
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective import ops as tops
from bluefog_tpu_torch.collective import plan as tplan

SIZE = 8


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    # one monolithic combine per call on the JAX side, and the JAX
    # composite wire (bitwise its Pallas kernels)
    monkeypatch.setenv("BLUEFOG_PLAN_CHUNKS", "1")
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    bf.init(devices=cpu_devices[:SIZE], nodes_per_machine=2)
    bft.init(device="cpu", nodes_per_machine=2)
    yield
    bf.shutdown()
    bft.shutdown()


def _inputs(seed=0, shape=(SIZE, 1000), dtype=np.float32):
    return (np.random.RandomState(seed).randn(*shape) * 5.0).astype(dtype)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1e-30))


def _jx(x):
    return bf.worker_values(list(x))


def _tx(x):
    return bft.worker_values(list(x))


# -- classic collectives ---------------------------------------------------------------


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("shape", [(SIZE, 1000), (SIZE, 3, 7), (SIZE,)])
def test_allreduce_matches_jax(average, shape):
    x = _inputs(1, shape)
    _close(bft.allreduce(_tx(x), average=average).numpy(),
           bf.allreduce(_jx(x), average=average))


def test_allreduce_of_integers_averages_in_float32():
    x = np.arange(SIZE * 5, dtype=np.int32).reshape(SIZE, 5)
    got = bft.allreduce(_tx(x))
    want = np.asarray(bf.allreduce(_jx(x)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close(got.numpy(), want)
    np.testing.assert_array_equal(bft.allreduce(_tx(x), average=False).numpy(),
                                  np.asarray(bf.allreduce(_jx(x), average=False)))


@pytest.mark.parametrize("shape", [(SIZE, 6), (SIZE, 2, 3), (SIZE,)])
def test_allgather_matches_jax(shape):
    x = _inputs(2, shape)
    got, want = bft.allgather(_tx(x)).numpy(), np.asarray(bf.allgather(_jx(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("root", [0, 3, 7])
def test_broadcast_matches_jax(root):
    x = _inputs(3, (SIZE, 40))
    _close(bft.broadcast(_tx(x), root).numpy(), bf.broadcast(_jx(x), root))


def test_broadcast_refuses_a_root_out_of_range():
    with pytest.raises(ValueError, match="root_rank"):
        bft.broadcast(_tx(_inputs()), SIZE)


PAIRINGS = {
    "pairs": [(0, 1), (2, 5), (6, 3)],
    "targets": [1, 0, 5, 6, -1, 2, 3, None],
}


@pytest.mark.parametrize("spec", sorted(PAIRINGS))
@pytest.mark.parametrize("weights", [(None, None), (0.75, 0.25)])
def test_pair_gossip_matches_jax(spec, weights):
    x = _inputs(4, (SIZE, 33))
    got = bft.pair_gossip(_tx(x), PAIRINGS[spec], *weights).numpy()
    want = np.asarray(bf.pair_gossip(_jx(x), PAIRINGS[spec], *weights))
    _close(got, want)
    # ranks outside every pair keep their value
    np.testing.assert_array_equal(got[4], x[4])


def test_pair_gossip_keeps_outsiders_in_the_weight_dtype():
    x = np.arange(SIZE * 2, dtype=np.int32).reshape(SIZE, 2)
    got = bft.pair_gossip(_tx(x), [(0, 1)])
    want = np.asarray(bf.pair_gossip(_jx(x), [(0, 1)]))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [[(0, 0)], [(0, 1), (1, 2)], [(0, 9)], [1, 2, 0, 3, 4, 5, 6, 7],
                                 [1, 0, 3]])
def test_pair_gossip_refuses_what_jax_refuses(bad):
    with pytest.raises((ValueError, AssertionError)):
        bf.pair_gossip(_jx(_inputs()), bad)
    with pytest.raises(ValueError):
        bft.pair_gossip(_tx(_inputs()), bad)


def test_barrier_returns():
    bf.barrier()
    assert bft.barrier() is None


# -- neighbor_allreduce with weights ------------------------------------------------------


def _explicit_weights(seed=0):
    """Per-rank self and in-neighbour weights over the Exp2 graph, not
    normalized (the exact combine takes any weights)."""
    rng = np.random.RandomState(seed)
    topo = ttu.ExponentialTwoGraph(SIZE)
    ins = [[int(i) for i in np.nonzero(topo[:, j])[0] if i != j] for j in range(SIZE)]
    self_w = [float(v) for v in rng.uniform(0.1, 0.5, SIZE)]
    src_w = [{i: float(rng.uniform(0.05, 0.3)) for i in ins[j]} for j in range(SIZE)]
    return self_w, src_w


def _normalized_weights(seed=0):
    self_w, src_w = _explicit_weights(seed)
    out_self, out_src = [], []
    for sw, sd in zip(self_w, src_w):
        total = sw + sum(sd.values())
        out_self.append(sw / total)
        out_src.append({k: v / total for k, v in sd.items()})
    return out_self, out_src


def _set_exp2():
    bf.set_topology(tu.ExponentialTwoGraph(SIZE))
    bft.set_topology(ttu.ExponentialTwoGraph(SIZE))


def test_neighbor_allreduce_explicit_weights_matches_jax():
    _set_exp2()
    self_w, src_w = _explicit_weights()
    x = _inputs(5)
    got = bft.neighbor_allreduce(_tx(x), self_weight=self_w, src_weights=src_w).numpy()
    want = bf.neighbor_allreduce(_jx(x), self_weight=self_w, src_weights=src_w)
    _close(got, want)
    # and against the combine written out
    ref = np.array([self_w[j] * x[j] + sum(w * x[i] for i, w in src_w[j].items())
                    for j in range(SIZE)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_neighbor_allreduce_scalar_self_weight_and_dict_of_ranks():
    _set_exp2()
    _, src_w = _normalized_weights(1)
    spec = {j: src_w[j] for j in range(SIZE)}
    x = _inputs(6)
    _close(bft.neighbor_allreduce(_tx(x), self_weight=0.3, src_weights=spec).numpy(),
           bf.neighbor_allreduce(_jx(x), self_weight=0.3, src_weights=spec))


def _one_peer_weights(step):
    """``(self_weight, src_weights, dst_weights)`` of one step of the
    one-peer schedule over the exponential graph."""
    gens = [ttu.GetDynamicOnePeerSendRecvRanks(ttu.ExponentialGraph(SIZE), r)
            for r in range(SIZE)]
    for _ in range(step):
        for g in gens:
            next(g)
    pairs = [next(g) for g in gens]
    self_w = [1.0 / (len(recv) + 1) for _send, recv in pairs]
    src_w = [{i: 1.0 / (len(recv) + 1) for i in recv} for _send, recv in pairs]
    dst_w = [list(send) for send, _recv in pairs]
    return self_w, src_w, dst_w


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("compression", [None, "int8", "int4"])
def test_neighbor_allreduce_dynamic_weights_matches_jax(step, compression):
    self_w, src_w, dst_w = _one_peer_weights(step)
    x = _inputs(7 + step, (SIZE, 1500))
    kw = dict(self_weight=self_w, src_weights=src_w, dst_weights=dst_w, compression=compression)
    _close(bft.neighbor_allreduce(_tx(x), **kw).numpy(), bf.neighbor_allreduce(_jx(x), **kw))


def test_dst_weights_scale_both_ends():
    """``W[i, j] = dst_w_i[j] * src_w_j[i]``: a sender's scale multiplies
    the receiver's weight."""
    self_w, src_w, _ = _one_peer_weights(0)
    dst_w = [{d: 0.5 for d in send} for send in (list(s) for s in
                                                 (_one_peer_weights(0)[2]))]
    x = _inputs(11)
    got = bft.neighbor_allreduce(_tx(x), self_weight=self_w, src_weights=src_w,
                                 dst_weights=dst_w).numpy()
    want = bf.neighbor_allreduce(_jx(x), self_weight=self_w, src_weights=src_w,
                                 dst_weights=dst_w)
    _close(got, want)
    ref = np.array([self_w[j] * x[j] + sum(0.5 * w * x[i] for i, w in src_w[j].items())
                    for j in range(SIZE)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_quantized_wire_refuses_weights_that_are_not_normalized():
    _set_exp2()
    self_w, src_w = _explicit_weights()
    x = _inputs()
    for wire in ("int8", "int4"):
        with pytest.raises(ValueError, match="normalized"):
            bft.neighbor_allreduce(_tx(x), self_weight=self_w, src_weights=src_w,
                                   compression=wire)
        with pytest.raises(ValueError, match="normalized"):
            bf.neighbor_allreduce(_jx(x), self_weight=self_w, src_weights=src_w,
                                  compression=wire)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_neighbor_allreduce_explicit_normalized_quantized_matches_jax(wire):
    _set_exp2()
    self_w, src_w = _normalized_weights(2)
    x = _inputs(12, (SIZE, 2000))
    kw = dict(self_weight=self_w, src_weights=src_w, compression=wire)
    _close(bft.neighbor_allreduce(_tx(x), **kw).numpy(), bf.neighbor_allreduce(_jx(x), **kw))


def _misuse_cases():
    self_w, src_w = _explicit_weights()
    _, _, dst_w = _one_peer_weights(0)
    bad_src = [dict(d) for d in src_w]
    bad_src[0][3] = 0.5  # rank 3 is not an in-neighbour of rank 0 in Exp2(8)
    asym_dst = [list(d) for d in dst_w]
    asym_dst[0] = [3] if asym_dst[0] != [3] else [5]
    sw1, sr1, _ = _one_peer_weights(0)
    return {
        "self-without-src": (dict(self_weight=self_w), "the same time"),
        "src-without-self": (dict(src_weights=src_w), "the same time"),
        "dst-without-self": (dict(dst_weights=dst_w), "dynamic topology"),
        "flat-dict": (dict(self_weight=0.5, src_weights={1: 0.5}), "flat"),
        "not-in-neighbor": (dict(self_weight=self_w, src_weights=bad_src), "in-neighbors"),
        "asymmetric-dst": (dict(self_weight=sw1, src_weights=sr1, dst_weights=asym_dst),
                           "mismatch"),
    }


@pytest.mark.parametrize("case", sorted(_misuse_cases()))
def test_weight_misuse_raises_what_jax_raises(case):
    _set_exp2()
    kw, match = _misuse_cases()[case]
    x = _inputs()
    with pytest.raises(ValueError, match=match):
        bf.neighbor_allreduce(_jx(x), **kw)
    with pytest.raises(ValueError, match=match):
        bft.neighbor_allreduce(_tx(x), **kw)


def test_topo_check_can_be_disabled():
    sw1, sr1, dst = _one_peer_weights(0)
    asym = [list(d) for d in dst]
    asym[0] = [3] if asym[0] != [3] else [5]
    x = _inputs(13)
    kw = dict(self_weight=sw1, src_weights=sr1, dst_weights=asym, enable_topo_check=False)
    _close(bft.neighbor_allreduce(_tx(x), **kw).numpy(), bf.neighbor_allreduce(_jx(x), **kw))


def test_unknown_compression_raises():
    with pytest.raises(ValueError, match="compression"):
        bft.neighbor_allreduce(_tx(_inputs()), compression="int2")


# -- plan_from_weights ---------------------------------------------------------------------


def _plans_equal(tp, jp):
    assert tp.perms == jp.perms
    assert tp.self_weights == jp.self_weights
    assert [r.recv_weights for r in tp.rounds] == [r.recv_weights for r in jp.rounds]
    np.testing.assert_array_equal(tp.weight_matrix(), jp.weight_matrix())


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_plan_from_weights_matches_jax_dynamic(step):
    self_w, src_w, dst_w = _one_peer_weights(step)
    _plans_equal(tplan.plan_from_weights(SIZE, self_w, src_w, dst_w),
                 jplan.plan_from_weights(SIZE, self_w, src_w, dst_w))


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_from_weights_matches_jax_explicit(seed):
    self_w, src_w = _explicit_weights(seed)
    _plans_equal(tplan.plan_from_weights(SIZE, self_w, src_w),
                 jplan.plan_from_weights(SIZE, self_w, src_w))
    dst = [{d: 0.25 * (1 + (i + d) % 3) for d in range(SIZE)
            if i in src_w[d]} for i in range(SIZE)]
    _plans_equal(tplan.plan_from_weights(SIZE, 0.5, src_w, dst),
                 jplan.plan_from_weights(SIZE, 0.5, src_w, dst))


def test_plan_from_weights_zero_weight_edge_is_kept():
    src = [{(j - 1) % SIZE: 0.0} for j in range(SIZE)]
    tp, jp = tplan.plan_from_weights(SIZE, 1.0, src), jplan.plan_from_weights(SIZE, 1.0, src)
    _plans_equal(tp, jp)
    assert tp.max_in_degree == 1


# -- neighbor_allgather ---------------------------------------------------------------------


ALLGATHER_TOPOLOGIES = {
    "exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
    "star": (tu.StarGraph, ttu.StarGraph),
    "mesh": (tu.MeshGrid2DGraph, ttu.MeshGrid2DGraph),
}


@pytest.mark.parametrize("topo", sorted(ALLGATHER_TOPOLOGIES))
@pytest.mark.parametrize("compression", [None, "bf16", "int8", "int4"])
def test_neighbor_allgather_matches_jax(topo, compression):
    """Per-rank lists, ragged on the star and the mesh; every wire bitwise
    equal to the JAX package's (int8/int4: the same encode, and the
    dequantization of the received rows)."""
    jgen, tgen = ALLGATHER_TOPOLOGIES[topo]
    bf.set_topology(jgen(SIZE))
    bft.set_topology(tgen(SIZE))
    x = _inputs(14, (SIZE, 3, 700))
    got = bft.neighbor_allgather(_tx(x), compression=compression)
    want = bf.neighbor_allgather(_jx(x), compression=compression)
    assert len(got) == len(want) == SIZE
    for r in range(SIZE):
        assert tuple(got[r].shape) == tuple(want[r].shape)
        assert got[r].dtype == torch.float32
        np.testing.assert_array_equal(got[r].numpy().view(np.int32),
                                      np.asarray(want[r]).view(np.int32))
    if compression is None:
        ins = bft.in_neighbor_ranks()
        for r in range(SIZE):
            np.testing.assert_array_equal(got[r].numpy(), x[ins[r]])


def test_neighbor_allgather_on_the_star_is_ragged():
    bft.set_topology(ttu.StarGraph(SIZE))
    got = bft.neighbor_allgather(_tx(_inputs(15, (SIZE, 4))))
    assert [g.shape[0] for g in got] == [SIZE - 1] + [1] * (SIZE - 1)


def test_neighbor_allgather_refuses_what_jax_refuses():
    x = _inputs()
    for bad, match in (("int2", "compression"),):
        with pytest.raises(ValueError, match=match):
            bft.neighbor_allgather(_tx(x), compression=bad)
        with pytest.raises(ValueError, match=match):
            bf.neighbor_allgather(_jx(x), compression=bad)
    xi = np.arange(SIZE * 4, dtype=np.int32).reshape(SIZE, 4)
    with pytest.raises(ValueError, match="float"):
        bft.neighbor_allgather(_tx(xi), compression="int8")
    with pytest.raises(ValueError, match="float"):
        bf.neighbor_allgather(_jx(xi), compression="int8")


# -- hierarchical ------------------------------------------------------------------------------


def test_context_machine_split_and_queries_match_jax():
    assert (bft.local_size(), bft.machine_size()) == (bf.local_size(), bf.machine_size()) == (2, 4)
    assert [bft.machine_rank(r) for r in range(SIZE)] == [bf.machine_rank(r) for r in range(SIZE)]
    assert bft.rank() == bf.rank() and bft.local_rank() == bf.local_rank()
    assert bft.is_homogeneous() and bf.is_homogeneous()
    assert bft.load_machine_topology() is None and bf.load_machine_topology() is None
    assert bft.in_neighbor_machine_ranks() is None and bf.in_neighbor_machine_ranks() is None
    bf.set_machine_topology(tu.StarGraph(4), is_weighted=True)
    bft.set_machine_topology(ttu.StarGraph(4), is_weighted=True)
    assert bft.is_machine_topo_weighted() and bf.is_machine_topo_weighted()
    assert bft.in_neighbor_machine_ranks() == bf.in_neighbor_machine_ranks()
    assert bft.out_neighbor_machine_ranks() == bf.out_neighbor_machine_ranks()
    assert bft.in_neighbor_machine_ranks(2) == bf.in_neighbor_machine_ranks(2)
    with pytest.raises(ValueError, match="machines"):
        bft.set_machine_topology(ttu.RingGraph(5))
    with pytest.raises(ValueError, match="divide"):
        bft.init(device="cpu", nodes_per_machine=3)


@pytest.mark.parametrize("weighted", [False, True])
def test_hierarchical_neighbor_allreduce_matches_jax(weighted):
    bf.set_machine_topology(tu.RingGraph(4), is_weighted=weighted)
    bft.set_machine_topology(ttu.RingGraph(4), is_weighted=weighted)
    x = _inputs(16, (SIZE, 2, 300))
    got = bft.hierarchical_neighbor_allreduce(_tx(x)).numpy()
    _close(got, bf.hierarchical_neighbor_allreduce(_jx(x)))
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("dynamic", [False, True])
def test_hierarchical_explicit_machine_weights_match_jax(dynamic):
    nbr = [{(m - 1) % 4: 0.25, (m + 1) % 4: 0.25} for m in range(4)]
    send = [[(m - 1) % 4, (m + 1) % 4] for m in range(4)] if dynamic else None
    x = _inputs(17)
    kw = dict(self_weight=0.5, neighbor_machine_weights=nbr, send_neighbor_machines=send)
    _close(bft.hierarchical_neighbor_allreduce(_tx(x), **kw).numpy(),
           bf.hierarchical_neighbor_allreduce(_jx(x), **kw))


def test_hierarchical_misuse():
    x = _tx(_inputs())
    with pytest.raises(ValueError, match="machine topology"):
        bft.hierarchical_neighbor_allreduce(x)
    with pytest.raises(ValueError, match="together"):
        bft.hierarchical_neighbor_allreduce(x, self_weight=0.5)
    with pytest.raises(ValueError, match="flat"):
        bft.hierarchical_neighbor_allreduce(x, self_weight=0.5,
                                            neighbor_machine_weights={1: 0.5})


# -- the handle model --------------------------------------------------------------------------


def _nonblocking_cases():
    self_w, src_w, dst_w = _one_peer_weights(1)
    nbr = [{(m + 1) % 4: 0.5} for m in range(4)]
    return {
        "allreduce": (lambda m, x: m.allreduce_nonblocking(x), lambda m, x: m.allreduce(x)),
        "allgather": (lambda m, x: m.allgather_nonblocking(x), lambda m, x: m.allgather(x)),
        "broadcast": (lambda m, x: m.broadcast_nonblocking(x, 2), lambda m, x: m.broadcast(x, 2)),
        "neighbor_allreduce": (
            lambda m, x: m.neighbor_allreduce_nonblocking(
                x, self_weight=self_w, src_weights=src_w, dst_weights=dst_w),
            lambda m, x: m.neighbor_allreduce(
                x, self_weight=self_w, src_weights=src_w, dst_weights=dst_w)),
        "neighbor_allreduce_int8": (
            lambda m, x: m.neighbor_allreduce_nonblocking(x, compression="int8"),
            lambda m, x: m.neighbor_allreduce(x, compression="int8")),
        "neighbor_allgather_int4": (
            lambda m, x: m.neighbor_allgather_nonblocking(x, compression="int4"),
            lambda m, x: m.neighbor_allgather(x, compression="int4")),
        "hierarchical": (
            lambda m, x: m.hierarchical_neighbor_allreduce_nonblocking(
                x, self_weight=0.5, neighbor_machine_weights=nbr),
            lambda m, x: m.hierarchical_neighbor_allreduce(
                x, self_weight=0.5, neighbor_machine_weights=nbr)),
        "pair_gossip": (lambda m, x: m.pair_gossip_nonblocking(x, [(0, 7), (1, 2)]),
                        lambda m, x: m.pair_gossip(x, [(0, 7), (1, 2)])),
    }


def _as_list(out):
    return [np.asarray(o) for o in out] if isinstance(out, list) else [np.asarray(out)]


@pytest.mark.parametrize("op", sorted(_nonblocking_cases()))
def test_nonblocking_then_synchronize_equals_blocking_and_jax(op):
    nonblocking, blocking = _nonblocking_cases()[op]
    x = _inputs(18, (SIZE, 600))
    handle = nonblocking(bft, _tx(x))
    assert isinstance(handle, int)
    assert bft.poll(handle)
    got = bft.synchronize(handle)
    for a, b in zip(_as_list(got), _as_list(blocking(bft, _tx(x)))):
        np.testing.assert_array_equal(a, b)
    jh = nonblocking(bf, _jx(x))
    for a, b in zip(_as_list(got), _as_list(bf.synchronize(jh))):
        _close(a, b)


def test_wait_is_synchronize_and_a_handle_is_used_once():
    h = bft.allreduce_nonblocking(_tx(_inputs()))
    bft.wait(h)
    assert bft.poll(h)
    with pytest.raises(ValueError, match="unknown handle"):
        bft.synchronize(h)


def test_ready_handles_past_the_bound_are_reaped(monkeypatch):
    monkeypatch.setattr(tops, "_HANDLE_REAP_THRESHOLD", 4)
    x = _tx(_inputs())
    handles = [bft.allreduce_nonblocking(x) for _ in range(10)]
    assert len(tops._handle_map) <= 5
    bft.synchronize(handles[-1])
    with pytest.raises(ValueError, match="unknown handle"):
        bft.synchronize(handles[0])


def test_worker_tensor_checks():
    with pytest.raises(ValueError, match="leading axis"):
        bft.allreduce(torch.zeros(SIZE + 1, 3))
    with pytest.raises(ValueError, match="per-worker"):
        bft.worker_values([np.zeros(2)] * 3)


# -- utility -----------------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(SIZE, 3, 4).astype(np.float32),
            "b": {"c": rng.randn(SIZE, 5).astype(np.float32),
                  "d": rng.randn(SIZE).astype(np.float32)}}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _assert_trees_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_close(got[k], want[k])
    else:
        _close(got.numpy(), want)


@pytest.mark.parametrize("root", [0, 5])
def test_broadcast_parameters_and_state_match_jax(root):
    t = _tree(20)
    for tfn, jfn in ((bft.broadcast_parameters, bf.broadcast_parameters),
                     (bft.broadcast_optimizer_state, bf.broadcast_optimizer_state)):
        _assert_trees_close(tfn(_map(t, torch.from_numpy), root), jfn(_map(t, _jx), root))


def test_allreduce_parameters_matches_jax():
    t = _tree(21)
    _assert_trees_close(bft.allreduce_parameters(_map(t, torch.from_numpy)),
                        bf.allreduce_parameters(_map(t, _jx)))


def test_utility_refuses_unstacked_leaves_and_bad_roots():
    with pytest.raises(ValueError, match="worker-stacked"):
        bft.allreduce_parameters({"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="root_rank"):
        bft.broadcast_parameters({"a": torch.zeros(SIZE)}, root_rank=-1)
    with pytest.raises(ValueError, match="root_rank"):
        bf.broadcast_parameters({"a": bf.worker_values(np.zeros(1))}, root_rank=-1)
