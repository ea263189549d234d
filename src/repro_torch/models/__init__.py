"""Model-side consumers of the plan API: the compressed sparse FFN."""
from .sparse_linear import (  # noqa: F401
    CompressedFFN,
    PlannedFFN,
    compress_ffn,
    sparse_ffn_apply,
)
