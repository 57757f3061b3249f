"""A GPT-2 decoder (Radford et al. 2019) in plain float32 PyTorch.

Pre-norm blocks: LayerNorm, causal multi-head attention (scale
``1 / sqrt(head_dim)``), a residual; LayerNorm, a 4x MLP with GPT-2's
tanh gelu (``gelu_new``), a residual; a final LayerNorm and the LM head.
Learned token and position embeddings. The next-token loss is the mean
cross-entropy of ``logits[:, :-1]`` against ``tokens[:, 1:]``.

Where the configuration departs from the published model (its
``assumed``): the attention projections carry no bias, the LM head is a
matrix and a bias of its own (untied), and there is no dropout. Parameter
names are the flax module paths the port uses.

Weights start as GPT-2's: ``normal(0, initializer_range)`` for the
embeddings, every matrix and the head, the residual projections (the
attention output and the MLP's second matrix) scaled by ``1 / sqrt(2 *
n_layer)``, biases 0, LayerNorm scale 1 and bias 0.
"""

import math
from typing import List

import torch
import torch.nn.functional as F

from gossipbench.lib.weights import Param

# sequences a pass: the loss is a mean over tokens, so blocks of whole
# sequences give its gradient exactly, up to the order of the sums
ROWS = 2


def param_table(cfg) -> List[Param]:
    d, v, std = cfg["n_embd"], cfg["vocab_size"], cfg["initializer_range"]
    proj = std / math.sqrt(2 * cfg["n_layer"])

    def ln(name):
        return [Param(f"{name}.scale", (d,), mean=1.0), Param(f"{name}.bias", (d,))]

    table = [Param("Embed_0.embedding", (v, d), std=std),
             Param("pos", (cfg["n_positions"], d), std=std)]
    for i in range(cfg["n_layer"]):
        b = f"Block_{i}"
        table += ln(f"{b}.LayerNorm_0")
        table += [Param(f"{b}.Dense_0.kernel", (3 * d, d), std=std),
                  Param(f"{b}.Dense_1.kernel", (d, d), std=proj)]
        table += ln(f"{b}.LayerNorm_1")
        table += [Param(f"{b}.Dense_2.kernel", (4 * d, d), std=std),
                  Param(f"{b}.Dense_2.bias", (4 * d,)),
                  Param(f"{b}.Dense_3.kernel", (d, 4 * d), std=proj),
                  Param(f"{b}.Dense_3.bias", (d,))]
    table += ln("LayerNorm_0")
    table += [Param("Dense_0.kernel", (v, d), std=std), Param("Dense_0.bias", (v,))]
    return table


def _ln(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.scale"], p[f"{name}.bias"], eps)


def _linear(x, w, b, cast):
    y = cast(x) @ cast(w).t()
    return y if b is None else y + b


def _attention(q, k, v, cast):
    t = q.shape[-2]
    s = (cast(q) @ cast(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return cast(a) @ cast(v)


def loss_sum(p, tokens, cfg, cast) -> torch.Tensor:
    """The summed next-token cross-entropy of ``tokens [B, T]``."""
    d, h, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    b, t = tokens.shape
    x = p["Embed_0.embedding"][tokens] + p["pos"][:t]
    for i in range(cfg["n_layer"]):
        n = f"Block_{i}"
        qkv = _linear(_ln(p, f"{n}.LayerNorm_0", x, eps), p[f"{n}.Dense_0.kernel"], None, cast)
        q, k, v = (y.reshape(b, t, h, d // h).transpose(1, 2) for y in qkv.split(d, dim=-1))
        att = _attention(q, k, v, cast).transpose(1, 2).reshape(b, t, d)
        x = x + _linear(att, p[f"{n}.Dense_1.kernel"], None, cast)
        y = _linear(_ln(p, f"{n}.LayerNorm_1", x, eps), p[f"{n}.Dense_2.kernel"],
                    p[f"{n}.Dense_2.bias"], cast)
        y = F.gelu(y, approximate="tanh")
        x = x + _linear(y, p[f"{n}.Dense_3.kernel"], p[f"{n}.Dense_3.bias"], cast)
    logits = _linear(_ln(p, "LayerNorm_0", x, eps), p["Dense_0.kernel"], p["Dense_0.bias"], cast)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1), reduction="sum")


def loss_and_grads(p, batch, cfg, cast):
    """``(mean loss, gradients in the order of p's values)`` of one
    worker's ``batch = (tokens [B, T],)``, in blocks of :data:`ROWS`
    sequences."""
    (tokens,) = batch
    leaves = list(p.values())
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    total, grads = torch.zeros((), device=tokens.device), None
    for a in range(0, tokens.shape[0], ROWS):
        part = loss_sum(p, tokens[a:a + ROWS], cfg, cast) / count
        g = torch.autograd.grad(part, leaves)
        grads = list(g) if grads is None else [x.add_(y) for x, y in zip(grads, g)]
        total += part.detach()
    return total, grads


def half_batch(batch):
    """The batch's first half of the sequences (a fault the comparison
    must catch)."""
    return tuple(t[: t.shape[0] // 2] for t in batch)
