"""escape_ms_per_step: device time of the operations launched inside
``plan.apply.escape.densify`` and ``plan.apply.escape.gemm`` (the dense
escape) per step of the tracing-on span (``bench/program_trace.py``)."""
from bench import program_trace


def read(ctx):
    return program_trace.program(ctx, "escape_ms")
