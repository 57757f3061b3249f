# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's quantized wire (``bluefog_tpu_torch.collective.kernels``)
against the JAX package's Pallas kernels and the numpy wire reference.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them. Both are held bit for bit, and to ``collective/wire_ref.py``. The
CUDA kernels are compared with the plain versions in ``test_torch_cuda``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu import topology as tu
from bluefog_tpu.collective import inner as jinner, plan as jplan, wire_ref
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.collective import inner as tinner, kernels as tk
from bluefog_tpu_torch.collective.plan import plan_from_topology

from conftest import require_pallas

SIZE = 8
WIRES = ["int8", "int4"]


@pytest.fixture(autouse=True)
def pallas_or_skip():
    require_pallas()


def _jax_kernels():
    from bluefog_tpu.collective import kernels

    return kernels


def ragged_input(seed=0, n=3000, small=None):
    """``[8, n]`` f32 with a ragged tail (n % 512 != 0), one all-zero
    block, and one block of +-``small`` multiples (default: the f32
    ``tiny``, whose block scale is subnormal) in every row."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(SIZE, n) * 5.0).astype(np.float32)
    x[:, :512] = 0.0
    small = np.finfo(np.float32).tiny if small is None else small
    m = min(n, 1024) - 512
    x[:, 512:512 + m] = (
        small * rng.choice([-1.0, 1.0], (SIZE, m)) * rng.randint(1, 9, (SIZE, m))
    ).astype(np.float32)
    return x


# XLA:CPU runs with subnormals flushed to zero, so inside a JAX program
# the scale max(absmax, tiny) / 127 of an all-zero or +-tiny block (a
# subnormal) becomes 0, while numpy (wire_ref) and the port keep it. The
# comparisons against JAX programs therefore use a small block whose
# scale is normal, and check the zero block's scale as "0 in JAX, the
# wire_ref subnormal in the port"; the +-tiny block is held to wire_ref.
JAX_SMALL = 1e-30


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def _scales_np(s: torch.Tensor) -> np.ndarray:
    """Scales as numpy (bf16 via its bit pattern, for exact compares)."""
    if s.dtype == torch.bfloat16:
        return s.view(torch.int16).numpy().view(np.uint16)
    return s.numpy().view(np.uint32)


@pytest.mark.parametrize("wire", WIRES)
def test_encode_bitwise_equals_jax_kernel(wire):
    k = _jax_kernels()
    x = ragged_input(small=JAX_SMALL)
    payload, scales = tk.encode(tk.pad_blocks(torch.from_numpy(x)), wire)
    enc = jax.jit(k.encode, static_argnums=1)
    for j in range(SIZE):
        jp, js = enc(jnp.asarray(x[j]), wire)
        np.testing.assert_array_equal(payload[j].numpy(), np.asarray(jp))
        got, ref = _scales_np(scales[j]), _bits(js)
        # block 0 is all zeros: subnormal scale, flushed by XLA:CPU
        assert ref[0] == 0 and got[0] == _bits(wire_ref.np_encode(x[j], wire)[1])[0]
        np.testing.assert_array_equal(got[1:], ref[1:])


def _np_scale(x_row, wire):
    """The JAX programs' block scale in numpy: ``max(absmax, tiny)``
    times the f32 reciprocal of 127 or 7 (XLA's rewrite of the divide),
    bf16-snapped for int4."""
    import ml_dtypes

    blocks = np.pad(x_row, (0, -x_row.size % 512)).reshape(-1, 512)
    amax = np.maximum(np.abs(blocks).max(1), np.finfo(np.float32).tiny)
    s = amax * np.float32(1 / 7 if wire == "int4" else 1 / 127)
    return s.astype(ml_dtypes.bfloat16) if wire == "int4" else s


@pytest.mark.parametrize("wire", WIRES)
def test_encode_matches_wire_ref(wire):
    """Against the numpy wire reference, zero and subnormal-scale blocks
    included. ``wire_ref`` divides by 127 or 7 where the JAX programs
    multiply by the reciprocal (see ``kernels.RECIP_127``), so its scales
    may differ from the programs' (and the port's) in the last bit; the
    port's scale is the programs' rule exactly, within one ulp of
    ``wire_ref``'s, and given that scale the payload and the decode are
    ``wire_ref``'s bit for bit."""
    x = ragged_input()
    payload, scales = tk.encode(tk.pad_blocks(torch.from_numpy(x)), wire)
    lim = 7 if wire == "int4" else 127
    for j in range(SIZE):
        got = _scales_np(scales[j])
        np.testing.assert_array_equal(got, _bits(_np_scale(x[j], wire)))
        _rp, rs, _rx = wire_ref.np_encode(x[j], wire)
        assert np.abs(got.astype(np.int64) - _bits(rs).astype(np.int64)).max() <= 1
        sw = np.asarray(_np_scale(x[j], wire)).astype(np.float32)
        blocks = np.pad(x[j], (0, -x.shape[1] % 512)).reshape(-1, 512)
        q = np.clip(np.round(blocks / sw[:, None]), -lim, lim).astype(np.int8)
        ref_payload = wire_ref.np_pack_nibbles(q) if wire == "int4" else q
        np.testing.assert_array_equal(payload[j].numpy(), ref_payload)
        xhat = tk.unpad_blocks(tk.dequantize(payload, scales), x.shape[1])[j]
        np.testing.assert_array_equal(
            xhat.numpy(),
            wire_ref.np_decode(payload[j].numpy(), _np_scale(x[j], wire),
                               x.shape[1], wire),
        )


@pytest.mark.parametrize("wire", WIRES)
def test_composite_quantizers_match_jax(wire):
    """The ``inner._chunk_quantize*`` / ``_dequant*`` ports against the
    JAX composite quantizers on a ragged input."""
    x = ragged_input(seed=1, n=1000, small=JAX_SMALL)
    quant = tinner._chunk_quantize4 if wire == "int4" else tinner._chunk_quantize
    jquant = jinner._chunk_quantize4 if wire == "int4" else jinner._chunk_quantize
    q, s, xhat = quant(torch.from_numpy(x))
    for j in range(SIZE):
        jq, js, jxhat = jax.jit(jquant)(jnp.asarray(x[j]))
        np.testing.assert_array_equal(q[j].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_scales_np(s[j])[1:], _bits(js)[1:])
        np.testing.assert_array_equal(xhat[j].numpy(), np.asarray(jxhat))


def test_unpack_all_256_bytes():
    """Every packed byte decodes to the reference's signed nibble pair,
    and packing inverts it for every in-range value."""
    packed = np.arange(256, dtype=np.uint8).view(np.int8).reshape(1, 256)
    ref = wire_ref.np_unpack_nibbles(packed)
    got = tk._unpack_nibbles(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, ref)
    q = np.random.RandomState(2).randint(-7, 8, (4, 512)).astype(np.int8)
    p = tk._pack_nibbles(torch.from_numpy(q))
    np.testing.assert_array_equal(p.numpy(), wire_ref.np_pack_nibbles(q))
    np.testing.assert_array_equal(tk._unpack_nibbles(p).numpy(), q)


def _topologies():
    return {
        "exp2": (tu.ExponentialTwoGraph, ttu.ExponentialTwoGraph),
        "star": (tu.StarGraph, ttu.StarGraph),
    }


@pytest.mark.parametrize("topo", ["exp2", "star"])
@pytest.mark.parametrize("wire", WIRES)
def test_decode_accumulate_bitwise_equals_jax_kernel(wire, topo):
    """All rounds folded into one pass, per receiving worker, against the
    JAX kernel fed what ``ppermute`` delivers (zeros for a rank outside a
    round's partial permutation, as the star plan has)."""
    k = _jax_kernels()
    jgen, tgen = _topologies()[topo]
    jp = jplan.plan_from_topology(jgen(SIZE), weighted=True)
    tp = plan_from_topology(tgen(SIZE), weighted=True)
    src, _self_w, recv_w = tinner.plan_operands(tp, "cpu")
    x = ragged_input(seed=3, small=JAX_SMALL)
    acc = tk.pad_blocks(torch.from_numpy(x)).clone()
    payload, scales = tk.encode(acc, wire)
    out = tk.decode_accumulate(acc, payload, scales, src, recv_w, wire)
    assert out is acc

    _jself_w, jrecv_w = jp.weight_operands()
    np.testing.assert_array_equal(jrecv_w, recv_w.numpy())
    dacc = jax.jit(k.decode_accumulate, static_argnums=5)
    enc = jax.jit(k.encode, static_argnums=1)
    sent = [enc(jnp.asarray(x[j]), wire) for j in range(SIZE)]
    n = x.shape[1]
    for j in range(SIZE):
        rounds = []
        for perm in jp.perms:
            senders = [s for s, d in perm if d == j]
            if senders:
                rounds.append(sent[senders[0]])
            else:
                rounds.append(tuple(jnp.zeros_like(a) for a in sent[j]))
        ref = dacc(jnp.asarray(x[j]), sent[j][0], sent[j][1], rounds,
                   jnp.asarray(jrecv_w[:, j]), wire)
        # XLA:CPU contracts acc + (deq_r - deq_s) * w into one FMA; the
        # port rounds the product and the sum separately (the CUDA kernel
        # is built with -fmad=false to pin exactly that), so each round
        # may differ by the product's rounding and then by the sum's:
        # the two agree to within one ulp of each round's product term
        # plus one ulp of each round's partial sum, summed over the rounds
        # (an ulp of the result alone would be meaningless where the sum
        # cancels). int4 products are exact, so int4 agrees bitwise.
        got, want = acc[j, :n].numpy(), np.asarray(ref)
        bound = np.zeros(n, np.float32)
        partial = x[j].copy()
        deq = tk.unpad_blocks(tk.dequantize(payload, scales), n).numpy()
        for r in range(src.shape[0]):
            i = int(src[r, j])
            recv = deq[i] if i >= 0 else np.zeros(n, np.float32)
            term = (recv - deq[j]) * recv_w[r, j].numpy()
            partial = partial + term
            bound += np.spacing(np.abs(term)) + np.spacing(np.abs(partial))
        assert (np.abs(got - want) <= bound).all()
        if wire == "int4":
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        # the zero tail stays exactly zero
        assert not acc[j, n:].any()


@pytest.mark.parametrize("wire", WIRES)
def test_decode_accumulate_matches_wire_ref_replay(wire):
    """The same combine replayed in numpy from ``wire_ref`` decodes."""
    tp = plan_from_topology(ttu.ExponentialGraph(SIZE), weighted=False)
    src, _self_w, recv_w = tinner.plan_operands(tp, "cpu")
    x = ragged_input(seed=4, n=1536)
    acc = torch.from_numpy(x.copy())
    payload, scales = tk.encode(acc, wire)
    tk.decode_accumulate(acc, payload, scales, src, recv_w, wire)
    enc = [wire_ref.np_encode(x[j], wire) for j in range(SIZE)]
    w = recv_w.numpy()
    for j in range(SIZE):
        y = x[j].copy()
        for r in range(src.shape[0]):
            i = int(src[r, j])
            recv = enc[i][2] if i >= 0 else np.zeros_like(y)
            y = y + (recv - enc[j][2]) * w[r, j]
        np.testing.assert_array_equal(acc[j].numpy(), y)


def test_wrappers_validate_shapes():
    with pytest.raises(ValueError):
        tk.encode(torch.zeros(2, 100), "int8")
    with pytest.raises(ValueError):
        tk.encode(torch.zeros(2, 512), "fp4")
    acc = torch.zeros(2, 512)
    p, s = tk.encode(acc, "int8")
    with pytest.raises(ValueError):
        tk.decode_accumulate(acc, p, s, torch.zeros(1, 3, dtype=torch.int32),
                             torch.zeros(1, 3), "int8")



# -- encode_diff, decode_add, decode ---------------------------------------------


def _copy_input(seed, n=3000, small=None):
    """A CHOCO sender's public copy ``h`` beside ``ragged_input``: of the
    size of ``x`` elsewhere, zero on the all-zero block (so that block's
    difference is zero too) and on the small block (whose difference is
    then the small values themselves)."""
    rng = np.random.RandomState(seed)
    h = (rng.randn(SIZE, n) * 4.0).astype(np.float32)
    h[:, :min(n, 1024)] = 0.0
    return h


def _fma_bound(a, b):
    """One ulp of each of two roundings: what separates ``h + q * s``
    rounded twice (the port) from one FMA (XLA:CPU's contraction)."""
    return np.spacing(np.abs(a)) + np.spacing(np.abs(b))


@pytest.mark.parametrize("wire", WIRES)
def test_encode_diff_matches_jax_kernel(wire):
    """Payload and scales bitwise; the updated copy ``h + q * s`` bitwise
    for int4 (a nibble times a bf16 scale is exact in f32, so an FMA
    rounds as the separate add does) and within one ulp of the product
    and of the sum for int8, where XLA:CPU may contract the add into an
    FMA and the port (and its CUDA kernel, built with -fmad=false) rounds
    twice."""
    k = _jax_kernels()
    x = ragged_input(seed=6, small=JAX_SMALL)
    h0 = _copy_input(seed=7)
    h = tk.pad_blocks(torch.from_numpy(h0)).clone()
    payload, scales = tk.encode_diff(tk.pad_blocks(torch.from_numpy(x)), h, wire)
    enc = jax.jit(k.encode_diff, static_argnums=2)
    n = x.shape[1]
    for j in range(SIZE):
        jp, js, jh = enc(jnp.asarray(x[j]), jnp.asarray(h0[j]), wire)
        np.testing.assert_array_equal(payload[j].numpy(), np.asarray(jp))
        got_s, ref_s = _scales_np(scales[j]), _bits(js)
        assert ref_s[0] == 0  # the zero block's subnormal scale, flushed by XLA:CPU
        np.testing.assert_array_equal(got_s[1:], ref_s[1:])
        got, want = h[j, :n].numpy(), np.asarray(jh)
        if wire == "int4":
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        else:
            step = tk.unpad_blocks(tk.dequantize(payload, scales), n)[j].numpy()
            assert (np.abs(got - want) <= _fma_bound(step, got)).all()
        assert not h[j, n:].any()  # the padded tail stays zero


@pytest.mark.parametrize("wire", WIRES)
def test_encode_diff_matches_wire_ref(wire):
    """Against the numpy wire reference, zero and subnormal-scale blocks
    included: the payload quantizes ``x - h`` with the programs' scale,
    and the new copy is ``h + np_decode(payload)``, bit for bit."""
    x = ragged_input(seed=8)
    h0 = _copy_input(seed=9)
    h = tk.pad_blocks(torch.from_numpy(h0)).clone()
    payload, scales = tk.encode_diff(tk.pad_blocks(torch.from_numpy(x)), h, wire)
    n = x.shape[1]
    lim = 7 if wire == "int4" else 127
    for j in range(SIZE):
        d = x[j] - h0[j]
        sw = np.asarray(_np_scale(d, wire))
        np.testing.assert_array_equal(_scales_np(scales[j]), _bits(sw))
        blocks = np.pad(d, (0, -n % 512)).reshape(-1, 512)
        q = np.clip(np.round(blocks / sw.astype(np.float32)[:, None]), -lim, lim).astype(np.int8)
        np.testing.assert_array_equal(
            payload[j].numpy(), wire_ref.np_pack_nibbles(q) if wire == "int4" else q
        )
        want = h0[j] + wire_ref.np_decode(payload[j].numpy(), sw, n, wire)
        np.testing.assert_array_equal(h[j, :n].numpy().view(np.uint32), want.view(np.uint32))


def _delivered(sent, src_r, j):
    """What ``ppermute`` hands worker ``j`` in a round: its sender's
    payload pair, or zeros."""
    i = int(src_r[j])
    if i >= 0:
        return sent[i]
    return tuple(jnp.zeros_like(a) for a in sent[j])


@pytest.mark.parametrize("topo", ["exp2", "star"])
@pytest.mark.parametrize("wire", WIRES)
def test_decode_add_matches_jax_kernel(wire, topo):
    """One round's receive integration ``base + deq(payload[src[j]])``
    against the JAX kernel fed what ``ppermute`` delivers: bitwise for
    int4, within one ulp of the product and of the sum for int8 (the
    FMA contraction of ``test_encode_diff_matches_jax_kernel``). A
    worker outside the round's partial permutation (the star) adds the
    zero payload: its base, holding -0.0 here, comes back as +0.0."""
    k = _jax_kernels()
    _jgen, tgen = _topologies()[topo]
    src, _self_w, _recv_w = tinner.plan_operands(
        plan_from_topology(tgen(SIZE), weighted=True), "cpu")
    x = ragged_input(seed=10, small=JAX_SMALL)
    n = x.shape[1]
    payload, scales = tk.encode(tk.pad_blocks(torch.from_numpy(x)), wire)
    enc = jax.jit(k.encode, static_argnums=1)
    sent = [enc(jnp.asarray(x[j]), wire) for j in range(SIZE)]
    dadd = jax.jit(k.decode_add, static_argnums=3)
    base0 = _copy_input(seed=11)
    base0[:, 1024:1030] = -0.0
    for r in range(src.shape[0]):
        base = tk.pad_blocks(torch.from_numpy(base0)).clone()
        out = tk.decode_add(base, payload, scales, src[r], wire)
        assert out is base
        deq = tk.unpad_blocks(tk.decode(payload, scales, src[r], wire), n).numpy()
        for j in range(SIZE):
            rq, rs = _delivered(sent, src[r], j)
            want = np.asarray(dadd(jnp.asarray(base0[j]), rq, rs, wire))
            got = base[j, :n].numpy()
            if wire == "int4":
                np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
            else:
                assert (np.abs(got - want) <= _fma_bound(deq[j], got)).all()
            if int(src[r, j]) < 0:
                assert not np.signbit(got[1024:1030]).any()


@pytest.mark.parametrize("topo", ["exp2", "star"])
@pytest.mark.parametrize("wire", WIRES)
def test_decode_bitwise_equals_jax_kernel(wire, topo):
    """Full-width decode of each worker's own payload and of each round's
    delivered payload: a single multiply, exact in f32, so bitwise."""
    k = _jax_kernels()
    _jgen, tgen = _topologies()[topo]
    src, _self_w, _recv_w = tinner.plan_operands(
        plan_from_topology(tgen(SIZE), weighted=True), "cpu")
    x = ragged_input(seed=12, small=JAX_SMALL)
    n = x.shape[1]
    payload, scales = tk.encode(tk.pad_blocks(torch.from_numpy(x)), wire)
    enc = jax.jit(k.encode, static_argnums=1)
    sent = [enc(jnp.asarray(x[j]), wire) for j in range(SIZE)]
    dec = jax.jit(k.decode, static_argnums=(2, 3))
    own = tk.decode(payload, scales, None, wire)
    assert own.shape == (SIZE, payload.shape[1] * 512)
    for j in range(SIZE):
        want = np.asarray(dec(sent[j][0], sent[j][1], n, wire))
        # block 0's scale is flushed to 0 in JAX, subnormal in the port:
        # both decode its zero payload to +0.0
        np.testing.assert_array_equal(own[j, :n].numpy().view(np.uint32), want.view(np.uint32))
    for r in range(src.shape[0]):
        got = tk.decode(payload, scales, src[r], wire)
        for j in range(SIZE):
            rq, rs = _delivered(sent, src[r], j)
            want = np.asarray(dec(rq, rs, n, wire))
            np.testing.assert_array_equal(got[j, :n].numpy().view(np.uint32),
                                          want.view(np.uint32))


@pytest.mark.parametrize("wire", WIRES)
def test_decode_and_decode_add_match_wire_ref(wire):
    """``decode`` is ``wire_ref.np_decode`` and ``decode_add`` is ``base +
    np_decode`` of the sender's row, bit for bit, with the subnormal
    scales kept."""
    src, _self_w, _recv_w = tinner.plan_operands(
        plan_from_topology(ttu.StarGraph(SIZE), weighted=True), "cpu")
    x = ragged_input(seed=13)
    n = x.shape[1]
    payload, scales = tk.encode(tk.pad_blocks(torch.from_numpy(x)), wire)
    s_np = [scales[j].float().numpy() for j in range(SIZE)]
    ref = [wire_ref.np_decode(payload[j].numpy(), s_np[j], n, wire) for j in range(SIZE)]
    own = tk.decode(payload, scales, None, wire)
    base0 = _copy_input(seed=14)
    for j in range(SIZE):
        np.testing.assert_array_equal(own[j, :n].numpy().view(np.uint32), ref[j].view(np.uint32))
    for r in range(src.shape[0]):
        base = tk.pad_blocks(torch.from_numpy(base0)).clone()
        tk.decode_add(base, payload, scales, src[r], wire)
        for j in range(SIZE):
            i = int(src[r, j])
            want = base0[j] + (ref[i] if i >= 0 else np.zeros(n, np.float32))
            np.testing.assert_array_equal(base[j, :n].numpy().view(np.uint32),
                                          want.view(np.uint32))


def test_new_wrappers_validate_operands():
    x = torch.zeros(2, 512)
    p, s = tk.encode(x, "int8")
    with pytest.raises(ValueError):
        tk.encode_diff(x, torch.zeros(2, 1024), "int8")
    with pytest.raises(ValueError):
        tk.encode_diff(torch.zeros(2, 100), torch.zeros(2, 100), "int8")
    with pytest.raises(ValueError):
        tk.decode_add(x.clone(), p, s, torch.tensor([0, 2], dtype=torch.int32), "int8")
    with pytest.raises(ValueError):
        tk.decode_add(x.clone(), p, s, torch.tensor([0, -2], dtype=torch.int32), "int8")
    # decode reads P >= len(src) payload rows (the transport's extended
    # payload): more output rows than payload rows, or a sender past them,
    # raise; fewer decode len(src) rows
    with pytest.raises(ValueError):
        tk.decode(p, s, torch.tensor([0, 1, 0], dtype=torch.int32), "int8")
    with pytest.raises(ValueError):
        tk.decode(p, s, torch.tensor([2], dtype=torch.int32), "int8")
    assert tk.decode(p, s, torch.tensor([1], dtype=torch.int32), "int8").shape == (1, 512)
    with pytest.raises(ValueError):
        tk.decode(p, s, None, "int4")


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_decode_reads_an_extended_payload(wire):
    """``decode`` with ``src [N]`` over a payload of ``P > N`` rows (the
    transport's extended payload, the local rows first): row ``j`` is
    ``deq(payload[src[j]])``, zeros for -1, bitwise the decode of the rows
    gathered first."""
    x = torch.from_numpy(np.random.RandomState(4).randn(5, 1024).astype(np.float32))
    p, s = tk.encode(x, wire)
    src = torch.tensor([4, -1, 0], dtype=torch.int32)
    got = tk.decode(p, s, src, wire)
    assert got.shape == (3, 1024)
    want = tk.decode(p[[4, 0, 0]], s[[4, 0, 0]], None, wire)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    assert not got[1].any()
