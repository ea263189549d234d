"""plan_prepare_s: phase 1's backend stage (``plan.prepare``: K1/K2's
schedules built and uploaded) of every layer in set-up, the sum of the
program's ``plan.prepare_s`` histogram (``repro_torch.obs``); nothing
where the program keeps no such histogram."""


def read(ctx):
    from repro_torch import obs

    hist = obs.get_registry().get("plan.prepare_s")
    return hist.sum if hist is not None and hist.count else None
