"""spmm_roofline: the traced steps' least time (each product's larger of
effectual operations over the fp32 peak and bytes over the HBM peak,
``bench/work.py``) as a share of the device time of every operation the
steps ran."""


def read(ctx):
    if not ctx.trace or not ctx.bound_s_per_step:
        return None
    bound = ctx.bound_s_per_step * ctx.trace["steps"]
    return 100.0 * bound / ctx.trace["device_s"]
