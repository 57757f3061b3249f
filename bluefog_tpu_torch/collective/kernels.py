# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The block-scaled quantized wire: ``encode``, ``encode_diff``,
``decode``, ``decode_add`` and ``decode_accumulate``.

Counterpart of ``bluefog_tpu/collective/kernels.py``. Each function has a
hand-written CUDA kernel for Hopper (``csrc/wire_kernels.cu``, built at
first use by :mod:`bluefog_tpu_torch._build`) and a plain PyTorch version
(``*_reference``) that runs the composite arithmetic of
``bluefog_tpu/collective/inner.py`` op for op. A CUDA tensor always takes
the kernel; a CPU tensor takes the plain version; anything else raises.

Stacked layout: ``N`` workers are the leading axis. A worker's flat
payload is cut into ``C`` blocks of :data:`CHUNK` elements, each with one
scale: int8 lanes with an f32 scale, or int4 nibbles packed two per int8
lane (element ``k`` in the low nibble of lane ``k``, element ``256 + k``
in the high nibble) with a bf16 scale.

The JAX ``ppermute`` of the received payloads is fused into the decoders:
round ``r`` reads worker ``src[r, j]``'s payload row directly (``-1``
delivers a zero payload with a zero scale, as ``ppermute`` does), so no
received copy exists.

The error-feedback copies (:func:`encode_diff` on the sender,
:func:`decode_add` on every receiver) integrate ``q * s`` with a multiply
and then an add, rounded separately, in the kernels and in the plain
versions alike, so the copies stay bit-identical; the plain versions never
use a fused multiply-add (``torch.addcmul``).
"""

import ctypes
from typing import Tuple

import torch

__all__ = [
    "CHUNK",
    "pad_blocks",
    "unpad_blocks",
    "encode",
    "encode_reference",
    "encode_diff",
    "encode_diff_reference",
    "decode",
    "decode_reference",
    "decode_add",
    "decode_add_reference",
    "decode_accumulate",
    "decode_accumulate_reference",
    "dequantize",
    "launch_counts",
    "reset_launch_counts",
]

CHUNK = 512
_HALF = CHUNK // 2
_WIRES = ("int8", "int4")


def _check_wire(wire: str) -> bool:
    """True for the packed (int4) wire; raises on an unknown tier."""
    if wire not in _WIRES:
        raise ValueError(f"wire must be one of {_WIRES}, got {wire!r}")
    return wire == "int4"


def pad_blocks(x: torch.Tensor) -> torch.Tensor:
    """``[N, n]`` -> ``[N, C * CHUNK]`` with a zero tail (``x`` itself
    when ``n`` is already a multiple of :data:`CHUNK`)."""
    n = x.shape[1]
    tail = -n % CHUNK
    if tail == 0:
        return x
    return torch.nn.functional.pad(x, (0, tail))


def unpad_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pad_blocks`: the first ``n`` elements per row."""
    return x.reshape(x.shape[0], -1)[:, :n]


# -- plain versions --------------------------------------------------------------


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """``[..., 512]`` int4 values (int8 storage) -> ``[..., 256]`` lanes,
    deinterleaved halves (``inner._pack_nibbles``)."""
    lo = q[..., :_HALF].to(torch.int32) & 0x0F
    hi = (q[..., _HALF:].to(torch.int32) & 0x0F) << 4
    byte = lo | hi  # 0..255; map to the int8 with the same bits
    return (byte - ((byte >> 7) << 8)).to(torch.int8)


def _unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_nibbles`: ``[..., 256]`` -> ``[..., 512]``
    int8 in [-8, 7]. The low nibble is sign-extended as ``((b & 15) ^ 8)
    - 8`` (equal to the JAX ``(b << 4) >> 4`` for every byte, without an
    int8 shift that overflows); the high one by an arithmetic shift."""
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


# The JAX quantizers write the scale as ``max(absmax, tiny) / 127.0`` (or
# ``/ 7.0``), but XLA's algebraic simplifier rewrites a division by a
# constant into a multiplication by the constant's f32 reciprocal, on the
# CPU as on the TPU. The JAX programs' wire bits are therefore those of
# ``max(absmax, tiny) * f32(1/127)``, which differ in the last bit from a
# true division on a few percent of int8 blocks and on about half of the
# int4 blocks. The port follows the programs.
RECIP_127 = float.fromhex("0x1.020408p-7")  # f32(1/127), bits 0x3c010204
RECIP_7 = float.fromhex("0x1.24924ap-3")  # f32(1/7), bits 0x3e124925


def _quantize_blocks(x2: torch.Tensor, packed: bool):
    """``[..., C, 512]`` f32 -> ``(q int8 [..., C, 512], s [..., C],
    s_f32 [..., C])``: ``inner._chunk_quantize`` / ``_chunk_quantize4``
    per block (the int4 scale snaps to bf16 before the divide)."""
    amax = torch.amax(x2.abs(), dim=-1)
    tiny = torch.finfo(torch.float32).tiny
    s = torch.clamp(amax, min=tiny) * (RECIP_7 if packed else RECIP_127)
    if packed:
        s_wire = s.to(torch.bfloat16)
        sw = s_wire.to(torch.float32)
        lim = 7
    else:
        s_wire = sw = s
        lim = 127
    q = torch.clamp(torch.round(x2 / sw[..., None]), -lim, lim).to(torch.int8)
    return q, s_wire, sw


def dequantize(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``(payload [..., C, 512|256], scales [..., C])`` -> ``[..., C, 512]``
    f32 reconstruction (``inner._dequant8`` / ``_dequant4``; every step is
    exact in f32)."""
    q = _unpack_nibbles(payload) if payload.shape[-1] == _HALF else payload
    return q.to(torch.float32) * scales.to(torch.float32)[..., None]


def encode_reference(x: torch.Tensor, wire: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`encode`."""
    packed = _check_wire(wire)
    n_workers = x.shape[0]
    x2 = x.reshape(n_workers, -1, CHUNK)
    q, s_wire, _sw = _quantize_blocks(x2, packed)
    return (_pack_nibbles(q) if packed else q), s_wire


def encode_diff_reference(
    x: torch.Tensor, h: torch.Tensor, wire: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`encode_diff` (``h`` updated in place)."""
    packed = _check_wire(wire)
    n_workers = x.shape[0]
    h3 = h.view(n_workers, -1, CHUNK)
    q, s_wire, sw = _quantize_blocks(x.reshape(n_workers, -1, CHUNK) - h3, packed)
    h3.add_(q.to(torch.float32) * sw[..., None])
    return (_pack_nibbles(q) if packed else q), s_wire


def _receive(payload: torch.Tensor, scales: torch.Tensor, src_r: torch.Tensor):
    """One round of the stacked ``ppermute`` of a wire pair: row ``j`` is
    sender ``src_r[j]``'s, or a zero payload with a zero scale where
    ``src_r[j] < 0``."""
    idx = src_r.to(torch.long)
    has = idx >= 0
    safe = idx.clamp(min=0)
    zero = lambda t: torch.zeros((), dtype=t.dtype, device=t.device)
    rq = torch.where(has[:, None, None], payload.index_select(0, safe), zero(payload))
    rs = torch.where(has[:, None], scales.index_select(0, safe), zero(scales))
    return rq, rs


def decode_reference(
    payload: torch.Tensor, scales: torch.Tensor, src_r, wire: str
) -> torch.Tensor:
    """Plain version of :func:`decode`."""
    _check_wire(wire)
    if src_r is not None:
        payload, scales = _receive(payload, scales, src_r)
    return dequantize(payload, scales).reshape(payload.shape[0], -1)


def decode_add_reference(
    base: torch.Tensor, payload: torch.Tensor, scales: torch.Tensor,
    src_r: torch.Tensor, wire: str,
) -> torch.Tensor:
    """Plain version of :func:`decode_add`."""
    _check_wire(wire)
    b3 = base.view(base.shape[0], -1, CHUNK)
    b3.add_(dequantize(*_receive(payload, scales, src_r)))
    return base


def decode_accumulate_reference(
    acc: torch.Tensor,
    payload: torch.Tensor,
    scales: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    wire: str,
) -> torch.Tensor:
    """Plain version of :func:`decode_accumulate`: the composite combine of
    ``inner.weighted_combine_quantized_operands`` with an explicit
    ``index_select`` for each round's ``ppermute`` (non-destinations
    receive a zero payload and a zero scale, as ``ppermute`` delivers)."""
    _check_wire(wire)
    n_workers = acc.shape[0]
    a3 = acc.view(n_workers, -1, CHUNK)
    deq_s = dequantize(payload[:n_workers], scales[:n_workers])
    out = a3
    for r in range(src.shape[0]):
        rq, rs = _receive(payload, scales, src[r])
        out = out + (dequantize(rq, rs) - deq_s) * w[r][:, None, None]
    a3.copy_(out)
    return acc


# -- kernels -------------------------------------------------------------------

_LAUNCHES = {"encode": 0, "encode_diff": 0, "decode": 0, "decode_add": 0,
             "decode_accumulate": 0}


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts` (the
    plain versions never count)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda_operand(t: torch.Tensor, name: str, dtype, device,
                        vector: bool = True) -> None:
    """Device, dtype and contiguity; ``vector`` operands are read and
    written with 8- and 16-byte accesses, so they must be 16-byte
    aligned."""
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(not vector or t.data_ptr() % 16 == 0,
             f"{name} must be 16-byte aligned")


def _raise_on_status(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError {status}")


def _dispatch_device(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"wire kernels run on cuda or cpu, got {t.device}")
    return t.device.type


def _wire_buffers(x: torch.Tensor, packed: bool):
    """Uninitialised ``(payload, scales)`` for the blocks of ``x [N, C *
    512]``."""
    n_workers, n_chunks = x.shape[0], x.shape[1] // CHUNK
    payload = torch.empty(
        (n_workers, n_chunks, _HALF if packed else CHUNK),
        dtype=torch.int8, device=x.device,
    )
    scales = torch.empty(
        (n_workers, n_chunks),
        dtype=torch.bfloat16 if packed else torch.float32, device=x.device,
    )
    return payload, scales


def encode(x: torch.Tensor, wire: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x [N, C * 512]`` f32 block by block: returns ``(payload
    [N, C, 512] int8 or [N, C, 256] packed int4, scales [N, C] f32 or
    bf16)`` — the JAX wire bits (replaces ``kernels.encode``)."""
    packed = _check_wire(wire)
    _require(x.dim() == 2 and x.shape[1] % CHUNK == 0,
             f"encode takes [N, C*{CHUNK}], got {tuple(x.shape)}")
    if _dispatch_device(x) == "cpu":
        return encode_reference(x, wire)
    from bluefog_tpu_torch import _build

    _check_cuda_operand(x, "x", torch.float32, x.device)
    payload, scales = _wire_buffers(x, packed)
    status = _build.wire_library().bf_wire_encode(
        _ptr(x), _ptr(payload), _ptr(scales), payload.shape[0] * payload.shape[1],
        int(packed), _stream(x),
    )
    _raise_on_status(status, "encode")
    _LAUNCHES["encode"] += 1
    return payload, scales


def encode_diff(
    x: torch.Tensor, h: torch.Tensor, wire: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The error-feedback (CHOCO) sender: quantize ``x - h`` block by
    block (``x``, ``h`` ``[N, C * 512]`` f32) and return ``(payload,
    scales)`` as :func:`encode` does, and integrate the very ``q`` it
    ships into the sender's public copy, ``h <- h + q * s``. Unlike the
    JAX function, which returns the new copy, ``h`` is updated in place
    (replaces ``kernels.encode_diff``)."""
    packed = _check_wire(wire)
    _require(x.dim() == 2 and x.shape[1] % CHUNK == 0,
             f"encode_diff takes [N, C*{CHUNK}], got {tuple(x.shape)}")
    _require(tuple(h.shape) == tuple(x.shape),
             f"h shape {tuple(h.shape)} does not match x {tuple(x.shape)}")
    if _dispatch_device(x) == "cpu":
        return encode_diff_reference(x, h, wire)
    from bluefog_tpu_torch import _build

    _check_cuda_operand(x, "x", torch.float32, x.device)
    _check_cuda_operand(h, "h", torch.float32, x.device)
    payload, scales = _wire_buffers(x, packed)
    status = _build.wire_library().bf_wire_encode_diff(
        _ptr(x), _ptr(h), _ptr(payload), _ptr(scales), payload.shape[0] * payload.shape[1],
        int(packed), _stream(x),
    )
    _raise_on_status(status, "encode_diff")
    _LAUNCHES["encode_diff"] += 1
    return payload, scales


def _check_wire_pair(payload, scales, n_workers, n_chunks, packed) -> None:
    """A wire pair of at least ``n_workers`` rows (``P >= N``: the
    multi-process transport's extended payload holds the local rows first,
    then the received ones)."""
    _require(payload.dim() == 3 and payload.shape[0] >= n_workers
             and tuple(payload.shape[1:]) == (n_chunks, _HALF if packed else CHUNK),
             f"payload shape {tuple(payload.shape)} does not match "
             f"[>= {n_workers}, {n_chunks}] blocks")
    _require(tuple(scales.shape) == (payload.shape[0], n_chunks),
             f"scales shape {tuple(scales.shape)} does not match the payload")


def _check_round_sources(src_r: torch.Tensor, n_workers: int, in_range: bool,
                         n_rows: int = None) -> None:
    """``src_r [N]`` with every entry in ``[-1, P)``, ``P`` the payload's
    rows (``n_rows``, default ``N``). The range check reads the tensor
    back (on the card, a synchronisation); callers whose ``src`` comes from
    a compiled plan, whose ranks are in range by construction, skip it with
    ``in_range=True``."""
    n_rows = n_workers if n_rows is None else n_rows
    _require(src_r.dim() == 1 and src_r.shape[0] == n_workers,
             f"src must be [{n_workers}], got {tuple(src_r.shape)}")
    if not in_range and src_r.numel():
        lo, hi = (int(v) for v in torch.aminmax(src_r.to(torch.int32)))
        _require(lo >= -1 and hi < n_rows,
                 f"src entries must lie in [-1, {n_rows}), got {lo}..{hi}")


def _check_cuda_pair(payload, scales, src_r, dev, packed) -> None:
    _check_cuda_operand(payload, "payload", torch.int8, dev)
    _check_cuda_operand(
        scales, "scales", torch.bfloat16 if packed else torch.float32, dev,
        vector=False,
    )
    if src_r is not None:
        _check_cuda_operand(src_r, "src", torch.int32, dev, vector=False)


def decode(
    payload: torch.Tensor, scales: torch.Tensor, src_r, wire: str,
    src_in_range: bool = False,
) -> torch.Tensor:
    """Full-width reconstruction ``[N, C * 512]`` f32 of a wire pair:
    row ``j`` is ``deq(payload[src_r[j]])``, zeros where ``src_r[j] ==
    -1``; ``src_r=None`` decodes every row's own payload (replaces
    ``kernels.decode``). With ``src_r [N]`` the payload may hold ``P >=
    N`` rows, ``src_r`` in ``[-1, P)`` (across processes: the transport's
    extended payload, the local rows first); the output has ``N`` rows.
    ``src_in_range=True`` skips the range check of ``src_r`` (see
    :func:`decode_add`)."""
    packed = _check_wire(wire)
    _require(payload.dim() == 3, f"payload must be [N, C, w], got {tuple(payload.shape)}")
    n_rows, n_chunks = payload.shape[:2]
    n_workers = n_rows if src_r is None or src_r.dim() != 1 else src_r.shape[0]
    _check_wire_pair(payload, scales, n_workers, n_chunks, packed)
    on_cpu = _dispatch_device(payload) == "cpu"
    if src_r is not None:
        _check_round_sources(src_r, n_workers, src_in_range, n_rows)
    if on_cpu:
        return decode_reference(payload, scales, src_r, wire)
    from bluefog_tpu_torch import _build

    dev = payload.device
    _check_cuda_pair(payload, scales, src_r, dev, packed)
    out = torch.empty((n_workers, n_chunks * CHUNK), dtype=torch.float32, device=dev)
    status = _build.wire_library().bf_wire_decode(
        _ptr(out), _ptr(payload), _ptr(scales),
        None if src_r is None else _ptr(src_r), n_workers, n_chunks,
        int(packed), _stream(out),
    )
    _raise_on_status(status, "decode")
    _LAUNCHES["decode"] += 1
    return out


def decode_add(
    base: torch.Tensor, payload: torch.Tensor, scales: torch.Tensor,
    src_r: torch.Tensor, wire: str, src_in_range: bool = False,
) -> torch.Tensor:
    """The error-feedback receive integration, ``base[j] +=
    deq(payload[src_r[j]])`` in place on ``base [N, C * 512]`` f32, with
    ``src_r [N]`` int32 naming each row's sender among the ``P >= N``
    payload rows (across processes: the transport's extended payload, the
    local rows first). ``src_r[j] == -1`` adds
    the zero payload (``+0.0``: a ``-0.0`` in ``base`` becomes ``+0.0``,
    as XLA's add of what ``ppermute`` delivers does). Returns ``base``
    (replaces ``kernels.decode_add``).

    ``src_r`` is checked to lie in ``[-1, N)``, which on the card reads
    it back; ``src_in_range=True`` (a source row of a compiled plan)
    skips that synchronisation."""
    packed = _check_wire(wire)
    _require(base.dim() == 2 and base.shape[1] % CHUNK == 0,
             f"base must be [N, C*{CHUNK}], got {tuple(base.shape)}")
    n_workers, n_chunks = base.shape[0], base.shape[1] // CHUNK
    _check_wire_pair(payload, scales, n_workers, n_chunks, packed)
    on_cpu = _dispatch_device(base) == "cpu"
    _check_round_sources(src_r, n_workers, src_in_range, payload.shape[0])
    if on_cpu:
        return decode_add_reference(base, payload, scales, src_r, wire)
    from bluefog_tpu_torch import _build

    dev = base.device
    _check_cuda_operand(base, "base", torch.float32, dev)
    _check_cuda_pair(payload, scales, src_r, dev, packed)
    status = _build.wire_library().bf_wire_decode_add(
        _ptr(base), _ptr(payload), _ptr(scales), _ptr(src_r), n_workers,
        n_chunks, int(packed), _stream(base),
    )
    _raise_on_status(status, "decode_add")
    _LAUNCHES["decode_add"] += 1
    return base


def decode_accumulate(
    acc: torch.Tensor,
    payload: torch.Tensor,
    scales: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    wire: str,
) -> torch.Tensor:
    """The difference-form combine epilogue, all rounds in one pass and
    ``acc [N, C * 512]`` f32 updated in place:

        acc[j] += (deq(payload[src[r, j]]) - deq(payload[j])) * w[r, j]

    for ``r = 0 .. R-1`` in order, where ``src [R, N]`` int32 names each
    round's sender (-1: none; that round adds ``(0 - deq_self) * 0``) and
    ``w [R, N]`` f32 the receiver weights. ``payload``/``scales`` are the
    :func:`encode` outputs of all workers, ``P >= N`` rows with row ``j``'s
    own payload at ``payload[j]`` (across processes: the transport's
    extended payload, the local rows first, ``src`` in ``[-1, P)``). Returns
    ``acc`` (replaces ``kernels.decode_accumulate``)."""
    packed = _check_wire(wire)
    n_workers = acc.shape[0]
    _require(acc.dim() == 2 and acc.shape[1] % CHUNK == 0,
             f"acc must be [N, C*{CHUNK}], got {tuple(acc.shape)}")
    n_chunks = acc.shape[1] // CHUNK
    _check_wire_pair(payload, scales, n_workers, n_chunks, packed)
    _require(src.dim() == 2 and src.shape[1] == n_workers
             and tuple(w.shape) == tuple(src.shape),
             "src and w must both be [R, N]")
    if _dispatch_device(acc) == "cpu":
        return decode_accumulate_reference(acc, payload, scales, src, w, wire)
    from bluefog_tpu_torch import _build

    dev = acc.device
    _check_cuda_operand(acc, "acc", torch.float32, dev)
    _check_cuda_pair(payload, scales, src, dev, packed)
    _check_cuda_operand(w, "w", torch.float32, dev, vector=False)
    status = _build.wire_library().bf_wire_decode_accumulate(
        _ptr(acc), _ptr(payload), _ptr(scales), _ptr(src), _ptr(w),
        n_workers, n_chunks, src.shape[0], int(packed), _stream(acc),
    )
    _raise_on_status(status, "decode_accumulate")
    _LAUNCHES["decode_accumulate"] += 1
    return acc
