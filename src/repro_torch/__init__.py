"""Flexagon on PyTorch and CUDA: the port of the ``repro`` JAX package.

Multi-dataflow SpMSpM for DNN serving on an NVIDIA H100.  The package
mirrors ``repro``'s layout; it covers the plan-once/execute-many operator
and the models and serving engine that consume it:

- :func:`flexagon_plan` / :class:`FlexagonPlan` — plan once, execute many;
- :class:`SparseOperand` / :class:`SparseFormat` — unified format surface;
- :class:`PlanCache` — LRU-bounded fingerprint-keyed plan reuse;
- :class:`FlexagonPipeline` — ``plan_network``-backed layer chain;
- ``repro_torch.backends`` — ``reference`` (torch executors), ``cuda``
  (the hand-written kernels in ``repro_torch.kernels``) and ``simulator``
  (the cycle models), plus the ``heuristic`` / ``simulator`` / ``autotune``
  selection policies;
- ``repro_torch.memory`` — :class:`MemoryBudget` / :data:`PAPER_BUDGET`
  and :class:`TiledPlan`: budgeted, tiled and mixed-dataflow execution;
- ``repro_torch.dist`` — :class:`DistPartition` and :class:`ShardedPlan`:
  plans sharded across a mesh (``repro_torch.launch.mesh``), one shard
  per rank merged by a ``torch.distributed`` ``all_reduce``;
- ``repro_torch.models`` — :func:`compress_ffn` / :func:`sparse_ffn_apply`,
  and the decoder LM (:func:`repro_torch.models.build_model`) with dense
  and MoE FFNs, whose ``sort`` dispatch runs the grouped-matmul kernel;
- ``repro_torch.serve`` — the continuous-batching ``ServeEngine``;
- ``repro_torch.convert`` — values carried over from the JAX package.

Entry points run on the card (``device=None`` → ``cuda``) unless the
caller passes ``device="cpu"``.  The package imports torch and numpy and
nothing of JAX.
"""
from .api import (  # noqa: F401
    PHASE1_COUNTERS,
    FlexagonPipeline,
    FlexagonPlan,
    PlanCache,
    SparseFormat,
    SparseOperand,
    flexagon_plan,
)
from .backends import (  # noqa: F401
    available_backends,
    get_backend,
    get_policy,
    register_backend,
)
from .memory import PAPER_BUDGET, MemoryBudget, TiledPlan  # noqa: F401
from .dist import DistPartition, Partitioner, ShardedPlan  # noqa: F401
from .models import compress_ffn, sparse_ffn_apply  # noqa: F401

__all__ = [
    "PHASE1_COUNTERS",
    "FlexagonPipeline",
    "FlexagonPlan",
    "PlanCache",
    "SparseFormat",
    "SparseOperand",
    "flexagon_plan",
    "available_backends",
    "get_backend",
    "get_policy",
    "register_backend",
    "MemoryBudget",
    "PAPER_BUDGET",
    "TiledPlan",
    "DistPartition",
    "Partitioner",
    "ShardedPlan",
    "compress_ffn",
    "sparse_ffn_apply",
]
