"""``flash_roofline``: the least time of the causal attention the step
needs (``lib/counts.py``: its matrix products at the dense bf16 peak, or
its bytes at the memory rate, whichever is longer) over the flash
kernels' traced device time."""

from gossipbench.harness import HERE
from gossipbench.lib.counts import attention_bytes, attention_flops, BF16_FLOPS, HBM_BYTES
from gossipbench.lib.trace import kernel_groups


def read(ctx):
    t = ctx.trace
    calls = ctx.family.attention_calls(ctx.cfg, ctx.mix)
    if t is None or not calls:
        return None
    group = kernel_groups(HERE)["flash"]
    busy = sum(s for k, s in t.kernel_s.items() if k in group)
    if busy <= 0:
        return None
    least = sum(n * max(attention_flops(b, s, h, d) / BF16_FLOPS,
                        attention_bytes(b, s, h, d) / HBM_BYTES)
                for n, b, s, h, d in calls)
    return 100.0 * least * t.steps / busy
