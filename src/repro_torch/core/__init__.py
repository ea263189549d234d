"""Flexagon core: multi-dataflow SpMSpM (the paper's contribution, in torch).

Layers:
  formats    — block and scalar (paper-exact) compressed formats
  dataflows  — numpy plan builders + the six dataflows as torch references
  selector   — phase-1 mapper/compiler: per-layer dataflow choice + network plan
  mrn        — functional Merger-Reduction Network model
  simulator  — cycle-level models of SIGMA-/SpArch-/GAMMA-like and Flexagon
  workloads  — DNN layer tables (paper Tables 2/6) for the evaluation
"""
from .formats import (  # noqa: F401
    BlockCSR, BlockCSC, CSR, CSC,
    dense_to_bcsr, dense_to_bcsc, random_block_sparse, random_sparse_dense,
    block_occupancy,
)
from .dataflows import (  # noqa: F401
    DATAFLOWS, OUTPUT_MAJOR, run_dataflow,
    ip_m, op_m, gust_m, ip_n, op_n, gust_n,
    build_ip_plan, build_op_plan, build_gust_plan,
)
from .selector import (  # noqa: F401
    DeviceSpec, LayerShape, estimate, estimate_all, select_dataflow,
    transition_needs_conversion, plan_network,
)
