"""plan_tables_s: phase 1's layouts and index plan (``plan.tables``) of
every layer in set-up, the sum of the program's ``plan.tables_s``
histogram (``repro_torch.obs``); nothing where the program keeps no such
histogram."""


def read(ctx):
    from repro_torch import obs

    hist = obs.get_registry().get("plan.tables_s")
    return hist.sum if hist is not None and hist.count else None
