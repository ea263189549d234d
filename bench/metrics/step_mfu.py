"""step_mfu: effectual operations of the window's steps over the window
(host clock) times the fp32 peak."""


def read(ctx):
    if not ctx.peaks or not ctx.steps or ctx.flops_per_step is None:
        return None
    flops = ctx.flops_per_step * ctx.steps
    return 100.0 * flops / (ctx.window_s * ctx.peaks["fp32_flop_per_s"])
