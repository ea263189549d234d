"""apply_us: the mean ``plan.apply`` span (``repro_torch.obs``, the
program's own clock) over the kept steps of the tracing-on span
(``bench/program_trace.py``)."""
from bench import program_trace


def read(ctx):
    return program_trace.program(ctx, "apply_us")
