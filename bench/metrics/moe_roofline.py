"""moe_roofline: the least time of the traced steps' K3 and K3w calls (each
call's larger of its effectual FLOPs over the dense bf16 peak and its bytes
over the HBM peak, counted from the real routed rows by
``bench/train_work.py``) as a share of those kernels' device time."""
from bench.train_trace import K3_KERNELS, K3W_KERNELS


def read(ctx):
    bound = getattr(getattr(ctx, "run", None), "moe_bound_s_per_step",
                    None)
    if not ctx.trace or not ctx.peaks or bound is None:
        return None
    busy = sum(ctx.trace["ops"].get(n, 0.0)
               for n in K3_KERNELS + K3W_KERNELS)
    if busy <= 0:
        return None
    return 100.0 * bound(ctx.peaks) * ctx.trace["steps"] / busy
