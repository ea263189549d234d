"""plan_select_s: phase 1's dataflow selection (``plan.select``) of every
layer in set-up, the sum of the program's ``policy.select_s`` histogram
(``repro_torch.obs``); nothing where the program keeps no such
histogram."""


def read(ctx):
    from repro_torch import obs

    hist = obs.get_registry().get("policy.select_s")
    return hist.sum if hist is not None and hist.count else None
