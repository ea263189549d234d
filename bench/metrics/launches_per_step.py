"""launches_per_step: K1 and K2 launches of the window (the program's
``stream_spmm.launches`` and ``stream_panel_spmm.launches``) per step."""


def read(ctx):
    return ctx.launches / ctx.steps if ctx.steps else None
