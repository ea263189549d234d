"""ingest_ms_per_step: device time of the operations launched inside
``plan.apply.ingest`` (B's, or A's, gathers through its layout) per step of
the tracing-on span (``bench/program_trace.py``)."""
from bench import program_trace


def read(ctx):
    return program_trace.program(ctx, "ingest_ms")
