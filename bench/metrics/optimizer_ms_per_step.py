"""optimizer_ms_per_step: device time of the operations owned by
``train.optimizer`` (clipping, the schedule and AdamW) per step of the
tracing-on span (``bench/train_trace.py``)."""
from bench import train_trace


def read(ctx):
    return train_trace.span_ms(ctx, ("train.optimizer",))
