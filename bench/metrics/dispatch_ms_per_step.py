"""dispatch_ms_per_step: device time of the operations launched inside
``plan.apply.dispatch`` or ``plan.apply.launch`` other than K1's and K2's
kernels (fp32 copies, transposes, the zeroed output, the cast) per step of
the tracing-on span (``bench/program_trace.py``)."""
from bench import program_trace


def read(ctx):
    return program_trace.program(ctx, "dispatch_ms")
