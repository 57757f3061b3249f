"""``torch_kernel_ms``: device milliseconds a step in kernels that are not
the port's own (cuDNN, cuBLAS, ATen): every traced kernel whose symbol no
``kernels/*.json`` group lists."""

from gossipbench.lib.trace import kernel_groups
from gossipbench.harness import HERE


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernel_s:
        return None
    own = set().union(*kernel_groups(HERE).values())
    return 1e3 * sum(s for k, s in t.kernel_s.items() if k not in own) / t.steps
