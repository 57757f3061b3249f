#!/usr/bin/env python
# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Long-context training on the PyTorch port: ring attention over a
sequence sharded across the workers.

The port's rendition of ``examples/long_context.py``: a small causal LM
trains on sequences ``size`` times longer than one worker's block. Each
worker holds one block of every sequence; the blocks are folded into the
batch, every block's attention is ring attention over the workers
(:func:`bluefog_tpu_torch.models.long_context.ring_attend`), and the loss
is the whole sequence's mean next-token loss, whose gradient (one backward
through the folded batch) is the sum of the workers' partial gradients.
The result must agree with the same model run dense on the whole sequence.

Task: next-token prediction on a periodic token stream whose period spans
worker boundaries (learnable only through cross-block attention).

    python examples/torch_long_context.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import bluefog_tpu_torch as bft  # noqa: E402
from bluefog_tpu_torch.models import TransformerLM, transformer  # noqa: E402
from bluefog_tpu_torch.models.long_context import (  # noqa: E402
    ring_attend,
    shard_sequence,
    sp_global_loss,
)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=60)
    args = parser.parse_args()

    bft.init(device=args.device)
    n = bft.size()
    dev = bft.get_context().device
    batch, block, vocab = 4, 16, 32
    total_len = n * block

    rng = np.random.RandomState(0)
    period = block + 3  # longer than a block: attention must cross workers
    base = rng.randint(0, vocab, size=period)
    stream = np.tile(base, (batch, total_len // period + 2))[:, :total_len + 1]
    tokens = torch.from_numpy(stream[:, :-1]).to(dev)
    targets = torch.from_numpy(stream[:, 1:]).to(dev)

    model = transformer.init_flax_like(
        TransformerLM(vocab=vocab, dim=32, heads=4, layers=2, max_len=total_len,
                      attend=ring_attend(n)), seed=0).to(dev)
    tok_s, tgt_s = shard_sequence(tokens, n), shard_sequence(targets, n)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    first = None
    for i in range(args.steps):
        opt.zero_grad()
        loss = sp_global_loss(model, tok_s, tgt_s)
        loss.backward()
        opt.step()
        if i == 0:
            first = float(loss.detach())
    with torch.no_grad():
        sp_loss = float(sp_global_loss(model, tok_s, tgt_s))
        dense = TransformerLM(vocab=vocab, dim=32, heads=4, layers=2, max_len=total_len).to(dev)
        dense.load_state_dict(model.state_dict())
        logits = dense(tokens)
        dense_loss = float(F.cross_entropy(logits.reshape(-1, vocab).float(),
                                           targets.reshape(-1)))
    print(f"[ring-attention LM] loss {first:.3f} -> {sp_loss:.4f} "
          f"(seq {total_len} over {n} workers)")
    print(f"[dense cross-check] loss {dense_loss:.4f} (|delta| = {abs(dense_loss - sp_loss):.2e})")
    ok = sp_loss < 0.5 * first and abs(dense_loss - sp_loss) < 1e-4
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
