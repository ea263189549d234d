"""attn_ms_per_step: device time of the operations owned by ``block.attn``
(attention's projections and blockwise softmax: forward, recomputation and
backward) per step of the tracing-on span (``bench/train_trace.py``)."""
from bench import train_trace


def read(ctx):
    return train_trace.span_ms(ctx, ("block.attn",))
