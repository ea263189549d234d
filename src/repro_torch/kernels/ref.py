"""Plain oracle for the SpMSpM kernels in this package.

Written with one dense product (no shared code with the kernels) so the
two cannot share bugs.
"""
from __future__ import annotations

import torch

__all__ = ["spmm_ref"]


def spmm_ref(a_dense, b_dense, out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B with fp32 accumulation — the oracle for every dataflow.

    All six dataflows and both kernels compute this same product; sparsity
    only changes *how*, never *what* (paper §2.2).
    """
    a = torch.as_tensor(a_dense).float()
    b = torch.as_tensor(b_dense).float()
    return torch.matmul(a, b).to(out_dtype)
