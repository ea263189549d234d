"""train_host_idle_share: share of the harness's traced span (tracing off)
in idle gaps whose next operation was launched after the gap began, so the
device waited on the host; joined through the launch calls'
``correlation`` (``bench/tracing.py``)."""
from bench import tracing


def read(ctx):
    rows = getattr(getattr(ctx, "run", None), "trace_rows", None) \
        if ctx.trace else None
    if not rows or not rows[0]:
        return None
    return tracing.host_idle_share(*rows)
