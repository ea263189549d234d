"""Hand-written CUDA kernels for the Flexagon hot spots, with their plain
PyTorch versions.

- ``stream.py`` — the shared :class:`StreamSchedule` work list and its two
  kernels, ``stream_spmm`` (K1, block runs: IP and OP) and
  ``stream_panel_spmm`` (K2, row panels: Gustavson), built from
  ``csrc/stream_spmm.cu`` by ``build.py`` at first use;
- ``ip_spmm`` / ``op_spmm`` / ``gust_spmm`` — the three dataflows as thin
  wrappers over those two kernels;
- ``moe_gmm.py`` — the MoE grouped matmul ``gmm`` (K3, from
  ``csrc/moe_gmm.cu``) and its group padding, host and device forms;
- ``attention.py`` — fused causal/windowed GQA attention, forward and
  backward (``csrc/attention.cu``), the kernel route of
  :func:`repro_torch.models.attention.blockwise_attention`;
- ``ops.py`` — the one-shot ``spmm_with_dataflow`` and the deprecated
  ``flexagon_spmm`` (phase 1 and ``apply`` on every call; the plan-once
  entry point is :func:`repro_torch.api.flexagon_plan`);
- ``ref.py`` — the dense oracles.

Plan-level dispatch lives in :mod:`repro_torch.backends.cuda`.
"""
from .ip_spmm import ip_spmm          # noqa: F401
from .op_spmm import op_spmm          # noqa: F401
from .gust_spmm import gust_spmm      # noqa: F401
from .stream import (  # noqa: F401
    SCHEDULE_KINDS,
    DeviceSchedule,
    StreamSchedule,
    device_schedule,
    pad_schedule,
    schedule_from_ip,
    schedule_from_stream,
    stream_panel_spmm,
    stream_panel_spmm_plain,
    stream_spmm,
    stream_spmm_plain,
)
from .moe_gmm import gmm, pad_groups  # noqa: F401
from .ops import flexagon_spmm, spmm_with_dataflow  # noqa: F401
from .ref import gmm_ref, moe_combine_ref, spmm_ref  # noqa: F401
