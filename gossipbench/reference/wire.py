"""The gossip wire as the reference computes it: plain PyTorch, no kernel.

The packing order and the block-int8 format are a frozen copy of the
format the port documents for its quantized wire (JAX's packed payload):

- a worker's parameters are one flat f32 row, the leaves in
  ``jax.tree_util`` order (dotted names compared part by part), each leaf
  in the JAX layout (a rank-4 ``kernel`` HWIO, a rank-2 ``kernel``
  ``[in, out]``, every other leaf as PyTorch holds it), zero-padded to a
  whole number of 512-element blocks;
- int8: per block the scale ``max(|x|).clip(tiny) / 127`` in f32 and the
  lanes ``clip(round(x / s), -127, 127)``; every receiver rebuilds
  ``q * s``;
- the combine of a receiver ``j`` in the difference form
  ``x_j + sum_r w_r (xhat_src(r, j) - xhat_j)``.
"""

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

ROW = 512


@dataclasses.dataclass(frozen=True)
class Slot:
    name: str
    shape: Tuple[int, ...]  # PyTorch layout
    kind: str  # "conv", "dense" or "same"
    offset: int
    numel: int


def _kind(name: str, shape: Sequence[int]) -> str:
    if name.rsplit(".", 1)[-1] == "kernel":
        if len(shape) == 4:
            return "conv"
        if len(shape) == 2:
            return "dense"
    return "same"


def layout(table) -> Tuple[List[Slot], int]:
    """``(slots, width)`` of a parameter table (entries with ``name`` and
    ``shape``): the wire row's leaves in JAX order and the padded width."""
    slots, off = [], 0
    for entry in sorted(table, key=lambda e: tuple(e.name.split("."))):
        n = math.prod(entry.shape)
        slots.append(Slot(entry.name, tuple(entry.shape), _kind(entry.name, entry.shape), off, n))
        off += n
    return slots, -(-off // ROW) * ROW


def leaf(row: torch.Tensor, slot: Slot) -> torch.Tensor:
    """The PyTorch-layout view of one leaf of a wire row."""
    v = row[slot.offset:slot.offset + slot.numel]
    if slot.kind == "conv":
        o, i, kh, kw = slot.shape
        return v.view(kh, kw, i, o).permute(3, 2, 0, 1)
    if slot.kind == "dense":
        out, inp = slot.shape
        return v.view(inp, out).t()
    return v.view(slot.shape)


def pack(slots: List[Slot], width: int, tensors, device) -> torch.Tensor:
    """One wire row from PyTorch-layout tensors by name."""
    row = torch.zeros(width, dtype=torch.float32, device=device)
    for s in slots:
        leaf(row, s).copy_(tensors[s.name])
    return row


def dequantized_int8(x: torch.Tensor) -> torch.Tensor:
    """``q * s`` of rows ``[..., C * 512]`` on the int8 wire."""
    blocks = x.reshape(*x.shape[:-1], -1, ROW)
    s = torch.clamp(blocks.abs().amax(-1), min=torch.finfo(torch.float32).tiny) / 127.0
    q = torch.clamp(torch.round(blocks / s[..., None]), -127, 127)
    return (q * s[..., None]).reshape(x.shape)


def exponential_sources(n: int) -> List[List[int]]:
    """``src[r][j]``: the sender of round ``r`` to receiver ``j`` on the
    exponential graph, where rank ``i`` sends to ``i + 2**r`` (mod n)."""
    offsets = [1 << r for r in range(max(1, (n - 1).bit_length())) if (1 << r) < n]
    return [[(j - o) % n for j in range(n)] for o in offsets]


def combine_int8_(x: torch.Tensor, src: List[List[int]], columns: int = 1 << 22) -> None:
    """The int8 neighbour combine of ``x [N, width]`` in place, uniform
    weights over the in-neighbours and the receiver, in column blocks of
    whole wire blocks (every receiver's block depends only on the same
    columns of its senders)."""
    w = 1.0 / (len(src) + 1)
    for a in range(0, x.shape[1], columns):
        part = x[:, a:a + columns]
        xhat = dequantized_int8(part)
        acc = part.clone()
        for senders in src:
            acc += (xhat[senders] - xhat) * w
        part.copy_(acc)
        del xhat, acc
