"""samples_per_s: samples of all steps of the window over the window,
from the first enqueue to the last completion, host clock."""


def read(ctx):
    return ctx.samples / ctx.window_s
