"""The ResNet family on the port: ``bluefog_tpu_torch.models.resnet.ResNet``
of bottleneck blocks, bf16 compute over f32 parameters, images NHWC."""

import torch

from gossipbench.families import DTYPES
from gossipbench.lib.weights import generator
from gossipbench.reference import resnet as reference


def build(cfg, device) -> torch.nn.Module:
    """The port's module on ``device``, its parameters left unset (the
    stacked row holds them) and its BatchNorm statistics at 0 and 1."""
    from bluefog_tpu_torch.models import resnet

    if cfg["block"] != "bottleneck":
        raise ValueError(f"block {cfg['block']!r}: the family builds bottleneck ResNets")
    with torch.device("meta"):
        module = resnet.ResNet(cfg["stage_sizes"], resnet.BottleneckBlock,
                               num_classes=cfg["num_classes"], num_filters=cfg["num_filters"],
                               dtype=DTYPES[cfg["compute_dtype"]])
    module.to_empty(device=device)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            buf.fill_(1.0 if name.endswith("var") else 0.0)
    return module


def program_loss():
    from bluefog_tpu_torch.models import classification_loss

    return classification_loss


def batches(cfg, mix, seed: int, device, count: int):
    """``count`` batches ``(images [N, B, H, W, C] bf16, labels [N, B])``:
    standard normal pixels, labels uniform over the classes."""
    gen = generator(seed, "data", device)
    n, b, s = mix["workers"], mix["batch"], cfg["image_size"]
    out = []
    for _ in range(count):
        images = torch.randn(n, b, s, s, cfg["channels"], generator=gen, device=device,
                             dtype=torch.bfloat16)
        labels = torch.randint(0, cfg["num_classes"], (n, b), generator=gen, device=device)
        out.append((images, labels))
    return out


def operands(batch, mix):
    """The train step's batch operands: images, labels and the worker
    indices on the host (BatchNorm updates worker j's statistics)."""
    return batch + (torch.arange(mix["workers"]),)


def macs(cfg) -> int:
    """Multiply-adds of one image's forward: every convolution and the
    classifier."""
    size = -(-cfg["image_size"] // 2)  # conv_init, stride 2
    total = size * size * cfg["num_filters"] * cfg["channels"] * 49
    size = -(-size // 2)  # the max pool
    features = cfg["num_filters"]
    for _name, inp, f, stride, projected in reference.blocks(cfg):
        out = -(-size // stride)
        total += size * size * f * inp  # Conv_0, 1x1 at the input's size
        total += out * out * f * f * 9  # Conv_1, 3x3 with the stride
        total += out * out * 4 * f * f  # Conv_2
        if projected:
            total += out * out * 4 * f * inp
        size, features = out, 4 * f
    return total + features * cfg["num_classes"]


def step_flops(cfg, mix) -> int:
    """Model FLOPs of one train step: forward and backward (3 x 2 x MACs)
    of every image of every worker."""
    return 6 * macs(cfg) * mix["workers"] * mix["batch"]


def attention_calls(cfg, mix):
    return []
