# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Carry state between the JAX package and the port, as numpy.

- Model parameters: flax ``params`` / ``batch_stats`` trees as nested
  dicts of numpy arrays (``jax.device_get(variables["params"])``) become
  PyTorch tensors keyed by the dotted module path of :mod:`models.resnet`
  and :mod:`models.transformer`. The layout is chosen per parameter, as
  :class:`models.stacked.StackedModel` chooses it
  (:func:`models.stacked.jax_layout`): conv kernels go HWIO -> OIHW, dense
  kernels ``[in, out]`` -> ``[out, in]``; everything else (vectors, the
  embedding table, the position table) is copied as it is.
- Error-feedback copies: the JAX optimizer's ``_ef`` (per dtype group
  ``(xhat_self [size, n], xhat_recv [size, R, n])``) and the port's
  (``(xhat_self [size, d], xhat_recv [R, size, d])``, ``d`` = ``n``
  padded to whole 512-element blocks).
- Windows: the lanes of a window (value, buffers, versions, p,
  p_buffers), which both packages lay out alike.

No JAX import: everything crosses as numpy.
"""

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.collective.kernels import CHUNK
from bluefog_tpu_torch.models.stacked import CONV, DENSE, jax_layout

__all__ = [
    "flatten_tree",
    "params_from_flax",
    "batch_stats_from_flax",
    "ef_state_from_jax",
    "ef_state_to_jax",
    "WINDOW_LANES",
    "window_lanes_from_jax",
    "window_lanes_to_jax",
]


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"a.b.c": leaf}`` (insertion order)."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten_tree(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def _to_torch_layout(a: np.ndarray, layout: str) -> np.ndarray:
    if layout == CONV:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if layout == DENSE:  # [in, out] -> [out, in]
        return a.T
    return a


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> PyTorch-layout f32 tensors by name."""
    return {
        name: torch.from_numpy(
            np.ascontiguousarray(_to_torch_layout(a, jax_layout(name, a.ndim))).astype(np.float32)
        )
        for name, a in flatten_tree(tree).items()
    }


def batch_stats_from_flax(tree) -> Dict[str, torch.Tensor]:
    """flax ``batch_stats`` tree (``mean``/``var`` per BatchNorm) -> f32
    tensors by the buffer names of :class:`models.resnet.BatchNorm`."""
    return {
        name: torch.from_numpy(np.ascontiguousarray(a).astype(np.float32))
        for name, a in flatten_tree(tree).items()
    }


def ef_state_from_jax(ef, device="cpu") -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """The JAX optimizer's CHOCO copies as the port's: per group
    ``xhat_self [size, d]`` and ``xhat_recv [R, size, d]`` f32, zero-padded
    to whole blocks."""
    out = []
    for xhat_self, xhat_recv in ef:
        xs, xr = np.asarray(xhat_self, np.float32), np.asarray(xhat_recv, np.float32)
        size, n = xs.shape
        d = -(-n // CHUNK) * CHUNK
        ps = np.zeros((size, d), np.float32)
        ps[:, :n] = xs
        pr = np.zeros((xr.shape[1], size, d), np.float32)
        pr[:, :, :n] = xr.transpose(1, 0, 2)
        out.append((torch.from_numpy(ps).to(device), torch.from_numpy(pr).to(device)))
    return tuple(out)


def ef_state_to_jax(ef, sizes: Sequence[int]) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """Inverse of :func:`ef_state_from_jax`; ``sizes`` are the groups'
    per-worker element counts ``n``."""
    return tuple(
        (xs.cpu().numpy()[:, :n], xr.cpu().numpy()[:, :, :n].transpose(1, 0, 2))
        for (xs, xr), n in zip(ef, sizes)
    )


WINDOW_LANES = ("value", "buffers", "versions", "p", "p_buffers")


def window_lanes_from_jax(win, device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX window's lanes (the attributes of ``win``) as the port's
    tensors: value ``[size, *S]``, buffers ``[size, max_deg, *S]``,
    versions ``[size, max_deg]`` int32, p ``[size]`` and p_buffers
    ``[size, max_deg]`` f32."""
    return {k: torch.from_numpy(np.array(getattr(win, k))).to(device) for k in WINDOW_LANES}


def window_lanes_to_jax(win) -> Dict[str, np.ndarray]:
    """A port window's lanes as numpy, in the JAX layout (the same)."""
    return {k: getattr(win, k).cpu().numpy() for k in WINDOW_LANES}
