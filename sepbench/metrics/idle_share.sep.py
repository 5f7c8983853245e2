"""idle_share.sep: the share of the profiled stretch of a separation
cell in which no kernel, copy or set ran on the device, in %."""


def read(ctx):
    if not ctx.trace or not ctx.trace.window_s:
        return None
    return 100 * (1 - ctx.trace.busy_s / ctx.trace.window_s)
