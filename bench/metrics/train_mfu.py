"""train_mfu: model FLOPs of the window's training steps (6 x active
matrix-product weights x tokens plus causal attention, no recomputation:
``bench/train_work.py``) over the window (host clock) times the dense
bf16 peak."""


def read(ctx):
    if not ctx.peaks or not ctx.steps or ctx.flops_per_step is None:
        return None
    flops = ctx.flops_per_step * ctx.steps
    return 100.0 * flops / (ctx.window_s * ctx.peaks["bf16_flop_per_s"])
