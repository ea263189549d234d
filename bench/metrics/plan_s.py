"""plan_s: phase 1 of every layer in set-up, the sum of the program's
``plan.build_s`` histogram (``repro_torch.obs``)."""


def read(ctx):
    return ctx.plan_s or None
