"""apply_host_us: host clock around each ``FlexagonPlan.apply`` of the
window, no synchronisation, the mean."""


def read(ctx):
    return ctx.apply_s / ctx.applies * 1e6 if ctx.applies else None
