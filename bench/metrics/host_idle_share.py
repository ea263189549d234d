"""host_idle_share: share of a tracing-off span's window in idle gaps whose
next operation was launched (its launch call returned) after the gap
began, so the device waited on the host; joined through the launch calls'
``correlation`` (``bench/program_trace.py``), no program span needed."""
from bench import program_trace


def read(ctx):
    got = program_trace.of(ctx)
    return got["host_idle_share"] if got else None
