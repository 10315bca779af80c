"""device_idle_share: the share of the traced window's wall time in which
no CUDA activity ran (1 - the union of their intervals over the window)."""


def idle_percent(busy_s, window_s):
    if not window_s or busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)


def read(ctx):
    return None if ctx.trace is None else idle_percent(ctx.trace.busy_s, ctx.trace.window_s)
