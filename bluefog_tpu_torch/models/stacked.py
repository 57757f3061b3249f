# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""N virtual workers of one model, parameters in one flat buffer.

The JAX package trains a worker-stacked params pytree inside
``shard_map``; the optimizer packs its leaves (in ``jax.tree_util`` order)
into one flat payload per dtype group for the gossip. Here that packed
payload IS the parameter store: one ``[N, C * 512]`` f32 buffer whose row
``j`` holds worker ``j``'s parameters in the flax tree order, each leaf in
the JAX element order, with a zero tail to the next 512-element wire
block. Which leaves change layout between the frameworks is a choice per
parameter (:func:`jax_layout`): a flax ``kernel`` is a conv kernel (HWIO
in JAX, OIHW here) or a dense kernel (``[in, out]`` in JAX, ``[out, in]``
here); every other parameter, embedding and position tables included, has
one layout in both. Each worker's
forward runs through ``torch.func.functional_call`` on (permuted) views
of its row, so gradients land in the same flat layout and the optimizer
gossips the buffer in place, with no pack or unpack copy.

Only parameters are gossiped; BatchNorm statistics stay per worker in
:attr:`StackedModel.buffers` (``[N, ...]`` each). The training loss is
the model's: :func:`classification_loss` (the classifier's default) or
:func:`next_token_loss` (a language model's).
"""

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from bluefog_tpu_torch import timeline as tl
from bluefog_tpu_torch.collective.kernels import CHUNK
from bluefog_tpu_torch.context import resolve_device

__all__ = [
    "ParamSlot",
    "StackedModel",
    "jax_order",
    "jax_layout",
    "classification_loss",
    "next_token_loss",
]

# A parameter's JAX layout against its PyTorch layout.
CONV = "conv"  # JAX HWIO, PyTorch OIHW
DENSE = "dense"  # JAX [in, out], PyTorch [out, in]
SAME = "same"  # one layout in both


def jax_layout(name: str, ndim: int) -> str:
    """The layout rule of one parameter, from its flax name: a ``kernel``
    of rank 4 is a conv kernel, of rank 2 a dense kernel; every other
    parameter (biases, scales, ``embedding``, ``pos``) keeps its layout."""
    if name.rsplit(".", 1)[-1] == "kernel":
        if ndim == 4:
            return CONV
        if ndim == 2:
            return DENSE
    return SAME


@dataclasses.dataclass(frozen=True)
class ParamSlot:
    """One parameter's place in a worker row."""

    name: str  # dotted module path, the flax tree path joined by "."
    shape: Tuple[int, ...]  # PyTorch layout
    offset: int
    numel: int
    layout: str = SAME

    @property
    def jax_shape(self) -> Tuple[int, ...]:
        if self.layout == CONV:  # OIHW -> HWIO
            o, i, kh, kw = self.shape
            return (kh, kw, i, o)
        if self.layout == DENSE:  # [out, in] -> [in, out]
            return (self.shape[1], self.shape[0])
        return self.shape


def to_jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A PyTorch-layout parameter as a view in the JAX layout."""
    if layout == CONV:
        return t.permute(2, 3, 1, 0)
    if layout == DENSE:
        return t.t()
    return t


def from_jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout`."""
    if layout == CONV:
        return t.permute(3, 2, 0, 1)
    if layout == DENSE:
        return t.t()
    return t


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of integer labels
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.to(torch.float32), labels)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy: ``logits[:, :-1]`` against
    ``tokens[:, 1:]``."""
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, vocab).to(torch.float32),
                           tokens[:, 1:].reshape(-1))


class _RowViews(torch.autograd.Function):
    """A worker row as its parameters' JAX-layout views, whose backward
    writes each view's gradient into one row-sized buffer (zero tail):
    the gradient with respect to the row costs one row write, where
    slicing the row directly would add a zero-padded row per parameter."""

    @staticmethod
    def forward(row, model):
        return tuple(model._jax_views(row))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.model = inputs[1]

    @staticmethod
    def backward(ctx, *grads):
        model = ctx.model
        ref = next(g for g in grads if g is not None)
        row = torch.empty(model.width, dtype=torch.float32, device=ref.device)
        row[model.n_params:].zero_()
        for dst, g in zip(model._jax_views(row), grads):
            if g is None:
                dst.zero_()
            else:
                dst.copy_(g)
        return row, None


def jax_order(names) -> List[str]:
    """Dotted parameter names sorted as ``jax.tree_util`` flattens the
    nested flax dict (keys sorted at every level: ``BottleneckBlock_10``
    before ``BottleneckBlock_2``, ``bias`` before ``kernel``)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


class StackedModel:
    """``size`` workers of ``module`` with their parameters in one flat
    ``[size, width]`` f32 buffer (see module docstring), on ``device``
    (default ``"cuda"``); ``loss(outputs, targets)`` is the training loss
    of one worker."""

    def __init__(self, module: nn.Module, size: int, device=None,
                 loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = classification_loss):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.size = size
        self.loss = loss
        shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
        slots, off = [], 0
        for name in jax_order(shapes):
            n = 1
            for d in shapes[name]:
                n *= d
            slots.append(ParamSlot(name, shapes[name], off, n,
                                   jax_layout(name, len(shapes[name]))))
            off += n
        self.slots: List[ParamSlot] = slots
        self.n_params = off
        self.width = -(-off // CHUNK) * CHUNK
        self.buffers: Dict[str, torch.Tensor] = {
            name: buf.detach().unsqueeze(0).repeat(
                (size,) + (1,) * buf.dim()
            ).contiguous()
            for name, buf in module.named_buffers()
        }

    @torch.no_grad()
    def pack(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One worker row ``[width]`` from PyTorch-layout tensors by name."""
        row = torch.zeros(self.width, dtype=torch.float32, device=self.device)
        for s in self.slots:
            row[s.offset:s.offset + s.numel].view(s.jax_shape).copy_(
                to_jax_layout(tensors[s.name], s.layout)
            )
        return row

    def _jax_views(self, row: torch.Tensor) -> List[torch.Tensor]:
        """JAX-layout views of one worker row, in slot order."""
        return [row[s.offset:s.offset + s.numel].view(s.jax_shape) for s in self.slots]

    def views(self, row: torch.Tensor) -> Dict[str, torch.Tensor]:
        """PyTorch-layout views of one worker row, by parameter name."""
        return {s.name: from_jax_layout(v, s.layout)
                for s, v in zip(self.slots, self._jax_views(row))}

    def replicate(self) -> torch.Tensor:
        """``[size, width]`` with every worker holding ``module``'s current
        parameters (the JAX benchmark's ``stack(params)``)."""
        row = self.pack(dict(self.module.named_parameters()))
        return row.unsqueeze(0).repeat(self.size, 1).contiguous()

    @torch.no_grad()
    def load_buffers(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Set the BatchNorm statistics: one set for every worker, or
        one per worker (``[size, ...]`` each)."""
        for name, buf in self.buffers.items():
            buf.copy_(tensors[name].to(buf.device).expand_as(buf))

    def _worker_state(self, jax_views: List[torch.Tensor], j: int) -> Dict[str, torch.Tensor]:
        state = {s.name: from_jax_layout(v, s.layout) for s, v in zip(self.slots, jax_views)}
        state.update({name: buf[j] for name, buf in self.buffers.items()})
        return state

    def forward(self, params: torch.Tensor, inputs: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """Outputs ``[size, ...]`` of every worker on its inputs ``[size,
        ...]`` (images NHWC, or tokens). ``train=True`` uses and updates
        the batch statistics."""
        self.module.train(train)
        with torch.no_grad():
            return torch.stack([
                functional_call(self.module,
                                self._worker_state(self._jax_views(params[j]), j),
                                (inputs[j],))
                for j in range(self.size)
            ])

    def worker_loss(self, row: torch.Tensor, inputs: torch.Tensor, targets: torch.Tensor,
                    worker=None) -> torch.Tensor:
        """The training loss of one worker whose parameters are ``row``
        (``[width]``, differentiable): the loss function of
        :meth:`bluefog_tpu_torch.optimizers._GossipOptimizer.make_train_step`
        for this model. ``worker`` (an int, or a 0-d tensor on the host)
        names the worker whose batch statistics the forward uses and
        updates; it may be left out when the model has none. The gradient
        equals :meth:`loss_and_grad`'s, bit for bit."""
        if self.buffers and worker is None:
            raise ValueError("this model has batch statistics: pass the worker index")
        j = 0 if worker is None else int(worker)
        self.module.train(True)
        leaves = _RowViews.apply(row, self)
        outputs = functional_call(self.module, self._worker_state(list(leaves), j), (inputs,))
        return self.loss(outputs, targets)

    def loss_and_grad(self, params: torch.Tensor, inputs: torch.Tensor,
                      targets: torch.Tensor, grads: torch.Tensor = None):
        """Training forward and backward of every worker, one after
        another: returns ``(loss [size] f32, grads [size, width])`` with the
        gradient in the flat JAX layout (zero in the tail), and updates the
        batch statistics. Worker ``j``'s loss is ``self.loss(module(inputs[j]),
        targets[j])``; each worker's is a ``forward`` and a ``backward``
        phase span, as in the fused train step."""
        self.module.train(True)
        if grads is None:
            grads = torch.empty_like(params)
        losses = torch.empty(self.size, dtype=torch.float32, device=params.device)
        for j in range(self.size):
            # the gradient is taken with respect to each parameter's own
            # view: with respect to the whole row, the backward of every
            # slice would build and add a row-sized zero-padded gradient
            leaves = [v.requires_grad_(True) for v in self._jax_views(params[j].detach())]
            with tl.span("forward", tl.PHASE):
                outputs = functional_call(
                    self.module, self._worker_state(leaves, j), (inputs[j],)
                )
                loss = self.loss(outputs, targets[j])
            with tl.span("backward", tl.PHASE):
                for dst, g in zip(self._jax_views(grads[j]), torch.autograd.grad(loss, leaves)):
                    dst.copy_(g)
            losses[j] = loss.detach()
        grads[:, self.n_params:].zero_()
        return losses, grads
