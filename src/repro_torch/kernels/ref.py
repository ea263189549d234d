"""Plain oracles for the kernels in this package.

Written with plain dense products (no shared code with the kernels) so the
two cannot share bugs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["spmm_ref", "gmm_ref", "moe_combine_ref"]


def spmm_ref(a_dense, b_dense, out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B with fp32 accumulation — the oracle for every dataflow.

    All six dataflows and both kernels compute this same product; sparsity
    only changes *how*, never *what* (paper §2.2).
    """
    a = torch.as_tensor(a_dense).float()
    b = torch.as_tensor(b_dense).float()
    return torch.matmul(a, b).to(out_dtype)


def gmm_ref(x, w, group_sizes, out_dtype=torch.float32) -> torch.Tensor:
    """Grouped matmul oracle: rows of ``x`` are partitioned into contiguous
    groups; group g multiplies ``w[g]`` (fp32 products).

    x: (M, K); w: (G, K, N); group_sizes: (G,) ints summing to M.
    """
    x = torch.as_tensor(x).float()
    w = torch.as_tensor(w).float()
    outs = []
    off = 0
    for g, size in enumerate(np.asarray(group_sizes).tolist()):
        outs.append(torch.matmul(x[off: off + size], w[g]))
        off += int(size)
    return torch.cat(outs, dim=0).to(out_dtype)


def moe_combine_ref(expert_out, combine_weights) -> torch.Tensor:
    """Weighted combine of per-(token, slot) expert outputs.

    expert_out: (T, S, D); combine_weights: (T, S) -> (T, D).
    """
    return torch.einsum("tsd,ts->td", torch.as_tensor(expert_out),
                        torch.as_tensor(combine_weights))
