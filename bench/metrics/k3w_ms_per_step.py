"""k3w_ms_per_step: device time of K3w's kernels (the experts' weight
gradients) per traced training step."""

NAMES = ("wgrad_tma_kernel", "wgrad_mma_kernel", "wgrad_fma_kernel")


def read(ctx):
    if not ctx.trace:
        return None
    s = sum(ctx.trace["ops"].get(n, 0.0) for n in NAMES)
    return s / ctx.trace["steps"] * 1e3 if s > 0 else None
