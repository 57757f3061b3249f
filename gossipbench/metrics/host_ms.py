"""``host_ms``: host milliseconds a step inside the train step's call
(dispatch, before the wait for the card), the benchmark's own span over
the window's untraced steps. Moves ``step_ms`` where the host sets the
pace."""


def read(ctx):
    if not ctx.host_s:
        return None
    return 1e3 * sum(ctx.host_s) / len(ctx.host_s)
