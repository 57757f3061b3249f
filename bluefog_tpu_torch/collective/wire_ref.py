# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The numpy reference of the block-scaled packed wire.

Counterpart of ``bluefog_tpu/collective/wire_ref.py``, the host-side
source of truth of the wire format (the SLO canary's replay,
:func:`bluefog_tpu_torch.slo.canary_expected`, checks every delivered edge
against it). Pure numpy: the bf16 snap of the int4 scale is
:func:`bf16_round`, a round-to-nearest-even on the float32 bits, where the
JAX package casts through ``ml_dtypes.bfloat16``; both give the same bits.

Format (that of :mod:`bluefog_tpu_torch.collective.kernels`, with one
difference: the kernels and their plain versions, like the JAX programs
after XLA's rewrite, multiply by the f32 reciprocal of 127 or 7 where this
replay divides, so a block's scale can differ in its last bit):

- flat payload zero-padded to 512-element blocks (``ROW``);
- int8: per-block scale ``max|x|.clip(tiny) / 127`` shipped in f32,
  lanes ``clip(round(x / s), -127, 127)``;
- int4: scale ``max|x|.clip(tiny) / 7`` snapped to bf16 before
  quantizing, lanes in [-7, 7] packed two nibbles per int8 lane: block
  element ``k`` in the low nibble of lane ``k``, element ``256 + k`` in
  the high nibble; unpack sign-extends with arithmetic shifts.

The int4 scales are returned as float32 arrays holding the bf16 values
(every bf16 is a float32), where the JAX package returns a bf16 array.
"""

import numpy as np

__all__ = [
    "ROW",
    "bf16_round",
    "np_pack_nibbles",
    "np_unpack_nibbles",
    "np_encode",
    "np_decode",
    "np_chunk_quantize",
    "np_chunk_quantize4",
]

# Must equal kernels.CHUNK: one scale grid across every replica.
ROW = 512


def bf16_round(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, ties to even, as
    float32: bitwise ``x.astype(ml_dtypes.bfloat16)`` cast back to
    float32, subnormals and overflow to infinity included, a NaN becoming
    the quiet NaN of its sign."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    bits = x.view(np.uint32)
    lsb = (bits >> np.uint32(16)) & np.uint32(1)
    rounded = (bits + np.uint32(0x7FFF) + lsb) & np.uint32(0xFFFF0000)
    quiet = (bits & np.uint32(0x80000000)) | np.uint32(0x7FC00000)
    return np.where(np.isnan(x), quiet, rounded).view(np.float32)


def np_pack_nibbles(q):
    """[n_chunks, 512] int4 values in int8 storage -> [n_chunks, 256]
    packed int8 (deinterleaved-halves layout)."""
    half = q.shape[1] // 2
    lo = q[:, :half] & np.int8(0x0F)
    hi = np.left_shift(q[:, half:], 4).astype(np.int8)
    return lo | hi


def np_unpack_nibbles(p):
    """Inverse of :func:`np_pack_nibbles` (arithmetic shifts sign-extend
    the nibbles back to [-8, 7])."""
    lo = np.right_shift(np.left_shift(p, 4).astype(np.int8), 4)
    hi = np.right_shift(p, 4)
    return np.concatenate([lo, hi], axis=1)


def _blocks(xf):
    n = xf.size
    n_chunks = -(-n // ROW)
    flat = np.pad(np.asarray(xf, np.float32).ravel(), (0, n_chunks * ROW - n))
    return flat.reshape(n_chunks, ROW), n


def np_encode(xf, wire):
    """Flat vector -> ``(payload, scales, xhat)`` in the wire format: int8
    -> ([n_chunks, 512] int8, [n_chunks] f32); int4 -> ([n_chunks, 256]
    packed int8, [n_chunks] f32 holding bf16 values). ``xhat`` is the flat
    [n] f32 reconstruction every receiver rebuilds from the same bits."""
    resh, n = _blocks(xf)
    if wire in ("int4", "int4_ef"):
        s = np.maximum(np.max(np.abs(resh), axis=1), np.finfo(np.float32).tiny) / 7.0
        sw = bf16_round(s)
        q = np.clip(np.round(resh / sw[:, None]), -7, 7).astype(np.int8)
        payload = np_pack_nibbles(q)
        return payload, sw, np_decode(payload, sw, n, "int4")
    s = np.maximum(np.max(np.abs(resh), axis=1), np.finfo(np.float32).tiny) / 127.0
    q = np.clip(np.round(resh / s[:, None]), -127, 127).astype(np.int8)
    s = s.astype(np.float32)
    return q, s, np_decode(q, s, n, "int8")


def np_decode(payload, scales, n, wire):
    """Wire pair -> flat [n] f32 reconstruction (exact f32 arithmetic,
    insensitive to evaluation order)."""
    q = np_unpack_nibbles(payload) if wire in ("int4", "int4_ef") else payload
    sw = np.asarray(scales).astype(np.float32)
    return (q.astype(np.float32) * sw[:, None]).reshape(-1)[:n]


def np_chunk_quantize(xf):
    """Reconstruction-only int8 replay."""
    return np_encode(xf, "int8")[2]


def np_chunk_quantize4(xf):
    """Reconstruction-only int4 replay, through the pack/unpack pair."""
    return np_encode(xf, "int4")[2]
