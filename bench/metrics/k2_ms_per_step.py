"""k2_ms_per_step: device time of K2's kernels per traced step."""

NAMES = ("stream_panel_kernel", "stream_panel_reduce_kernel")


def read(ctx):
    if not ctx.trace:
        return None
    s = sum(ctx.trace["ops"].get(n, 0.0) for n in NAMES)
    return s / ctx.trace["steps"] * 1e3 if s > 0 else None
