"""Model zoo of the port: the LM API and its blocks, and the model-side
consumers of the plan API (the compressed sparse FFN)."""
from .encdec import EncDec  # noqa: F401
from .lm import LM, build_model  # noqa: F401
from .sparse_linear import (  # noqa: F401
    CompressedFFN,
    PlannedFFN,
    compress_ffn,
    sparse_ffn_apply,
)
