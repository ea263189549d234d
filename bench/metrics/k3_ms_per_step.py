"""k3_ms_per_step: device time of K3's kernels (the experts' products of
the forward, of its recomputation and of the input gradients) per traced
training step."""

NAMES = ("gmm_mma_kernel", "gmm_fma_kernel", "gmm_reduce_kernel")


def read(ctx):
    if not ctx.trace:
        return None
    s = sum(ctx.trace["ops"].get(n, 0.0) for n in NAMES)
    return s / ctx.trace["steps"] * 1e3 if s > 0 else None
