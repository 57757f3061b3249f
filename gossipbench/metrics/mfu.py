"""``mfu``: model FLOPs of the window's untraced steps, counted from the
configuration's shapes (``families/<family>.py::step_flops``), over the
window's time and the card's dense bf16 peak."""

from gossipbench.lib.counts import BF16_FLOPS


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.steps:
        return None  # no device traced: no utilisation to report
    flops_per_s = ctx.step_flops * ctx.steps / ctx.window_s
    return 100.0 * flops_per_s / BF16_FLOPS
