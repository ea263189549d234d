"""The plain reference and the comparison that decides ``correct``.

The reference is one product in fp64 with plain torch, on the dense
operands the benchmark made; it imports nothing of the program.  The
control is the same product in TF32, the precision below the fp32 that
the configurations state: it stands in the program's place to show that
the comparison fails a lower precision.
"""
from __future__ import annotations

import torch


def product(a, b):
    """C = A @ B in fp64, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return a.double() @ b.double()


def control(a, b):
    """C = A @ B on fp32 operands in TF32 (the GPU's tensor cores)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a.float() @ b.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def rel_err(out, ref):
    """max |out - ref| / max |ref|, in fp64 (the plain max where the
    reference is all zeros)."""
    gap = float((out.double() - ref).abs().max()) if ref.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return gap / scale if scale > 0 else gap
