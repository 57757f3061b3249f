"""The GPT-2 family on the port: ``bluefog_tpu_torch.models.TransformerLM``
(bf16 compute over f32 parameters, the flash kernels, tanh gelu, an f32
LM head) with the next-token loss."""

import torch

from gossipbench.families import DTYPES
from gossipbench.lib.counts import attention_flops
from gossipbench.lib.weights import generator
from gossipbench.reference import gpt2 as reference


def _check(cfg) -> None:
    if cfg["activation_function"] != "gelu_new":
        raise ValueError("the port's blocks use the tanh gelu (gelu_new)")
    if cfg.get("tie_word_embeddings"):
        raise ValueError("the port's LM head is a matrix of its own")
    if any(cfg.get(k) for k in ("attn_pdrop", "embd_pdrop", "resid_pdrop")):
        raise ValueError("the port's model has no dropout")


def build(cfg, device) -> torch.nn.Module:
    """The port's module on ``device``, its parameters left unset (the
    stacked row holds them), every LayerNorm at the configuration's
    epsilon."""
    from bluefog_tpu_torch.models import TransformerLM
    from bluefog_tpu_torch.models.transformer import LayerNorm

    _check(cfg)
    with torch.device("meta"):
        module = TransformerLM(vocab=cfg["vocab_size"], dim=cfg["n_embd"], heads=cfg["n_head"],
                               layers=cfg["n_layer"], max_len=cfg["n_positions"],
                               dtype=DTYPES[cfg["compute_dtype"]])
    module.to_empty(device=device)
    norms = [m for m in module.modules() if isinstance(m, LayerNorm)]
    if not norms or not all(hasattr(m, "epsilon") for m in norms):
        raise ValueError("the port's LayerNorm no longer holds its epsilon")
    for m in norms:
        m.epsilon = float(cfg["layer_norm_epsilon"])
    return module


def program_loss():
    from bluefog_tpu_torch.models import next_token_loss

    return next_token_loss


def batches(cfg, mix, seed: int, device, count: int):
    """``count`` batches ``(tokens [N, B, T],)``, ids uniform over the
    vocabulary."""
    if mix["seq"] > cfg["n_positions"]:
        raise ValueError(f"seq {mix['seq']} is past n_positions {cfg['n_positions']}")
    gen = generator(seed, "data", device)
    shape = (mix["workers"], mix["batch"], mix["seq"])
    return [(torch.randint(0, cfg["vocab_size"], shape, generator=gen, device=device),)
            for _ in range(count)]


def operands(batch, mix):
    """The train step's batch operands: the tokens as inputs and targets."""
    return batch + batch


def matmul_params(cfg) -> int:
    """Parameters that multiply a matrix: the blocks' four matrices and the
    LM head (not the embeddings, which are looked up)."""
    d, layers = cfg["n_embd"], cfg["n_layer"]
    return layers * (3 * d * d + d * d + 4 * d * d + 4 * d * d) + d * cfg["vocab_size"]


def step_flops(cfg, mix) -> int:
    """Model FLOPs of one train step: 6 a matmul parameter and token, and
    causal attention forward and backward (3 x its 2 forward products)."""
    dense = 6 * matmul_params(cfg) * mix["workers"] * mix["batch"] * mix["seq"]
    return dense + sum(n * attention_flops(b, t, h, d)
                       for n, b, t, h, d in attention_calls(cfg, mix))


def attention_calls(cfg, mix):
    """``(launches a step, b, t, heads, head_dim)`` of the causal flash
    attention: one forward and backward a block and worker."""
    h = cfg["n_head"]
    return [(cfg["n_layer"] * mix["workers"], mix["batch"], mix["seq"], h, cfg["n_embd"] // h)]
