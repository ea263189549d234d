"""moe_dispatch_ms_per_step: device time of the operations owned by the
sort dispatch's spans ``moe.route``, ``moe.permute`` and ``moe.combine``
(forward, recomputation and their backward) per step of the tracing-on
span (``bench/train_trace.py``)."""
from bench import train_trace


def read(ctx):
    return train_trace.span_ms(ctx, ("moe.route", "moe.permute",
                                     "moe.combine"))
