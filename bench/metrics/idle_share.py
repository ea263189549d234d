"""idle_share: share of the traced window in which no operation ran on
the device (profiler timeline, the device traced alone)."""


def read(ctx):
    if not ctx.trace:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
