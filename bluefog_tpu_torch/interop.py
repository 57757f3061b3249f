# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Carry the JAX model's parameters into the port.

Takes flax ``params`` / ``batch_stats`` trees as nested dicts of numpy
arrays (``jax.device_get(variables["params"])``) and returns PyTorch
tensors keyed by the dotted module path of :mod:`models.resnet`. Conv
kernels go HWIO -> OIHW and dense kernels ``[in, out]`` -> ``[out, in]``;
vectors are copied as they are. No JAX import: the trees are plain numpy.
"""

from typing import Dict

import numpy as np
import torch

__all__ = ["flatten_tree", "params_from_flax", "batch_stats_from_flax"]


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


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:  # [in, out] -> [out, in]
        return a.T
    return a


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> PyTorch-layout f32 tensors by name."""
    return {
        name: torch.from_numpy(
            np.ascontiguousarray(_to_torch_layout(a)).astype(np.float32)
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
