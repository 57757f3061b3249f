"""ResNet (He et al. 2015, arXiv:1512.03385) in plain float32 PyTorch.

The bottleneck ResNet with the stride on the 3x3 convolution (v1.5), a
projection shortcut wherever the shape changes, ``SAME`` padding as
TensorFlow and flax define it (7x7/2 on 224 pads 2 before and 3 after),
a 3x3/2 max pool, BatchNorm on the batch's statistics (epsilon 1e-5,
biased variance), a global mean pool and a float32 classifier. Parameter
names are the flax module paths the port uses, so both sides can be
compared leaf by leaf.

Weights start as in Goyal et al. 2017 (arXiv:1706.02677, section 5.1),
the large-batch recipe whose learning rate the mix uses: every
convolution as the paper's reference [13] (He et al., "Delving Deep into
Rectifiers"), ``normal(0, sqrt(2 / (k * k * c_in)))``; the classifier
``normal(0, 0.01)``; BatchNorm scale 1 and bias 0, except the scale of
each block's last BatchNorm, 0 (each block starts as its shortcut, as the
port's own initialisation has it).
"""

import math
from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

from gossipbench.lib.weights import Param

EPS = 1e-5
# Faults inside the model the comparison must catch: the 3x3 convolution
# of the first block, its weight gradient or its input gradient halved.
FAULTS = ("residual_wgrad", "residual_dgrad")
FAULT_BLOCK = "BottleneckBlock_0"


def blocks(cfg) -> Iterator[Tuple[str, int, int, int, bool]]:
    """``(name, in_features, filters, stride, projected)`` of every block."""
    features, k = cfg["num_filters"], 0
    for i, count in enumerate(cfg["stage_sizes"]):
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            filters = cfg["num_filters"] * 2 ** i
            yield (f"BottleneckBlock_{k}", features, filters, stride,
                   features != 4 * filters or stride != 1)
            features, k = 4 * filters, k + 1


def _conv(name: str, out: int, inp: int, k: int) -> Param:
    return Param(f"{name}.kernel", (out, inp, k, k), std=math.sqrt(2.0 / (k * k * inp)))


def _bn(name: str, c: int, scale: float = 1.0) -> List[Param]:
    return [Param(f"{name}.scale", (c,), mean=scale), Param(f"{name}.bias", (c,))]


def param_table(cfg) -> List[Param]:
    f0 = cfg["num_filters"]
    table = [_conv("conv_init", f0, cfg["channels"], 7)] + _bn("bn_init", f0)
    features = f0
    for name, inp, f, _stride, projected in blocks(cfg):
        table += [_conv(f"{name}.Conv_0", f, inp, 1)] + _bn(f"{name}.BatchNorm_0", f)
        table += [_conv(f"{name}.Conv_1", f, f, 3)] + _bn(f"{name}.BatchNorm_1", f)
        table += [_conv(f"{name}.Conv_2", 4 * f, f, 1)] + _bn(f"{name}.BatchNorm_2", 4 * f, 0.0)
        if projected:
            table += [_conv(f"{name}.conv_proj", 4 * f, inp, 1)] + _bn(f"{name}.norm_proj", 4 * f)
        features = 4 * f
    table += [Param("Dense_0.kernel", (cfg["num_classes"], features), std=0.01),
              Param("Dense_0.bias", (cfg["num_classes"],))]
    return table


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    ph = same_padding(x.shape[-2], kernel, stride)
    pw = same_padding(x.shape[-1], kernel, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _half_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient halved (both halves exact)."""
    return x * 0.5 + x.detach() * 0.5


def _conv2d(x, w, stride, cast):
    return F.conv2d(cast(_pad(x, w.shape[-1], stride)), cast(w), stride=stride)


def _bn2d(p, name, x):
    return F.batch_norm(x, None, None, p[f"{name}.scale"], p[f"{name}.bias"],
                        training=True, eps=EPS)


def loss(p, batch, cfg, cast, fault=None) -> torch.Tensor:
    """Mean cross-entropy of one worker: ``batch = (images [B, H, W, C],
    labels [B])``, with one of :data:`FAULTS` planted where ``fault`` names
    it."""
    images, labels = batch
    x = images.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    x = F.relu(_bn2d(p, "bn_init", _conv2d(x, p["conv_init.kernel"], 2, cast)))
    x = F.max_pool2d(_pad(x, 3, 2, float("-inf")), 3, 2)
    for name, _inp, _f, stride, projected in blocks(cfg):
        y = F.relu(_bn2d(p, f"{name}.BatchNorm_0", _conv2d(x, p[f"{name}.Conv_0.kernel"], 1, cast)))
        w1 = p[f"{name}.Conv_1.kernel"]
        if name == FAULT_BLOCK and fault == "residual_wgrad":
            w1 = _half_grad(w1)
        if name == FAULT_BLOCK and fault == "residual_dgrad":
            y = _half_grad(y)
        y = F.relu(_bn2d(p, f"{name}.BatchNorm_1", _conv2d(y, w1, stride, cast)))
        y = _bn2d(p, f"{name}.BatchNorm_2", _conv2d(y, p[f"{name}.Conv_2.kernel"], 1, cast))
        if projected:
            x = _bn2d(p, f"{name}.norm_proj", _conv2d(x, p[f"{name}.conv_proj.kernel"], stride, cast))
        x = F.relu(x + y)
    x = x.mean(dim=(2, 3))
    logits = F.linear(cast(x), cast(p["Dense_0.kernel"]), p["Dense_0.bias"])
    return F.cross_entropy(logits, labels)


def loss_and_grads(p, batch, cfg, cast, fault=None):
    """``(loss, gradients in the order of p's values)``; ``p``'s values
    require gradients."""
    value = loss(p, batch, cfg, cast, fault)
    return value.detach(), torch.autograd.grad(value, list(p.values()))


def half_batch(batch):
    """The batch's first half (a fault the comparison must catch)."""
    return tuple(t[: t.shape[0] // 2] for t in batch)
