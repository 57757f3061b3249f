"""``device_idle``: the share of the traced sub-window in which no kernel,
copy or set ran on the card: 100 x (1 - the union of their intervals /
the sub-window)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
