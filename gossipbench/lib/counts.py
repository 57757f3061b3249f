"""The operations and bytes that the kernels' work needs, from shapes, and
the published peaks they are held to.

Bytes count each input read once and each output written once, whatever
a kernel reads again; operations count the matrix products the algorithm
needs (two multiply-adds a product element and term).
"""

CHUNK = 512  # elements a wire block, one scale each

# The H100 SXM's published dense peaks (NVIDIA data sheet), the card every
# cell runs on: bf16 operations a second and HBM3 bytes a second.
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
# The wire forms :func:`combine_bytes` prices, and the wire kernels one
# such combine launches: one encode of every row, one accumulate of the
# received payloads.
WIRES = ("int8", "int4")
COMBINE_LAUNCHES = {"encode": 1, "decode_accumulate": 1}


def wire_bytes(wire: str, elems: int) -> int:
    """Payload plus scales of ``elems`` elements (a multiple of 512)."""
    blocks = elems // CHUNK
    if wire == "int8":
        return elems + 4 * blocks
    if wire == "int4":
        return elems // 2 + 2 * blocks
    raise ValueError(f"no byte count for the {wire!r} wire")


def combine_bytes(wire: str, workers: int, width: int, rounds: int) -> int:
    """Least bytes of one quantized neighbour combine of ``[workers,
    width]`` f32 rows: the encode reads the rows and writes the payload and
    scales; the accumulate reads the rows, the payload and scales (once,
    though every round reads a sender's row of it), the round table (int32
    senders and f32 weights) and writes the rows."""
    rows = 4 * workers * width
    payload = wire_bytes(wire, workers * width)
    encode = rows + payload
    accumulate = rows + payload + 8 * rounds * workers + rows
    return encode + accumulate


def causal_pairs(t: int) -> int:
    return t * (t + 1) // 2


def attention_flops(b: int, t: int, h: int, d: int) -> int:
    """Causal self-attention forward and backward: 2 products forward (S =
    QK^T, O = PV), 4 backward (dV, dP, dQ, dK), each ``2 d`` operations a
    causal (query, key) pair."""
    return 6 * 2 * d * causal_pairs(t) * b * h


def attention_bytes(b: int, t: int, h: int, d: int, itemsize: int = 2) -> int:
    """Forward reads q, k, v, writes o and the f32 row statistics;
    backward reads q, k, v, o, dO and the statistics, writes dQ, dK, dV."""
    tile = b * t * h * d * itemsize
    stats = 4 * b * h * t
    return (3 * tile + tile + stats) + (5 * tile + stats + 3 * tile)
