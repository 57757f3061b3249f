"""``wire_roofline``: the least time of the wire kernels' bytes (one
plain quantized combine a step of ``[workers, width]`` f32 rows,
``lib/counts.py::combine_bytes``) at the card's memory rate, over their
traced device time. Nothing where the step's wire is another: a wire form
the count does not price, a graph other than the exponential one, or wire
kernels launched other than one plain combine a step (error feedback,
push-sum)."""

from gossipbench.harness import HERE
from gossipbench.lib.counts import COMBINE_LAUNCHES, HBM_BYTES, WIRES, combine_bytes
from gossipbench.lib.trace import kernel_groups


def read(ctx):
    t, m = ctx.trace, ctx.mix
    if t is None or m["compression"] not in WIRES or ctx.rounds is None:
        return None
    if ctx.wire_launches != COMBINE_LAUNCHES:
        return None
    group = kernel_groups(HERE)["wire"]
    busy = sum(s for k, s in t.kernel_s.items() if k in group)
    if busy <= 0:
        return None
    least = combine_bytes(m["compression"], m["workers"], ctx.width, ctx.rounds) / HBM_BYTES
    return 100.0 * least * t.steps / busy
