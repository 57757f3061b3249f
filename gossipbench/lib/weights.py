"""Seeds, and weights drawn on the device from them.

A parameter table lists each parameter's name, PyTorch-layout shape and
the normal distribution it starts from (``std`` 0 makes it the constant
``mean``). The draw is one flat f32 vector in the table's order, made in
a few calls on the device; the program and the reference each take views
of the same vector.
"""

import dataclasses
import hashlib
import math
from typing import Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    shape: Tuple[int, ...]
    std: float = 0.0
    mean: float = 0.0


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of a run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def count(table: Sequence[Param]) -> int:
    return sum(math.prod(p.shape) for p in table)


def draw(table: Sequence[Param], seed: int, device) -> torch.Tensor:
    """The flat f32 vector of every parameter, in table order."""
    device = torch.device(device)
    sizes = torch.tensor([math.prod(p.shape) for p in table], device=device)
    std = torch.tensor([p.std for p in table], dtype=torch.float32, device=device)
    mean = torch.tensor([p.mean for p in table], dtype=torch.float32, device=device)
    total = int(sizes.sum())
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    flat.mul_(torch.repeat_interleave(std, sizes, output_size=total))
    flat.add_(torch.repeat_interleave(mean, sizes, output_size=total))
    return flat


def views(table: Sequence[Param], flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each parameter as a view of the flat vector, by name."""
    out, off = {}, 0
    for p in table:
        n = math.prod(p.shape)
        out[p.name] = flat[off:off + n].view(p.shape)
        off += n
    return out
