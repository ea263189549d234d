"""step_ms_p95: the 95th percentile (nearest rank) over the window's
steps of each step's time on the device's clock: CUDA events recorded
before the step's first operation and after its last."""
import math


def read(ctx):
    ms = sorted(ctx.step_ms)
    return ms[math.ceil(0.95 * len(ms)) - 1] if ms else None
