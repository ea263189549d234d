"""plan_pattern_s: phase 1's pattern stage (``plan.pattern``: both
operands' block occupancy, B's values copied to the host for it) of
every layer in set-up, the sum of the program's ``plan.pattern_s``
histogram (``repro_torch.obs``); nothing where the program keeps no such
histogram."""


def read(ctx):
    from repro_torch import obs

    hist = obs.get_registry().get("plan.pattern_s")
    return hist.sum if hist is not None and hist.count else None
