"""The paper's nine representative DNN layers (Table 6).

:data:`PAPER_LAYERS` holds each layer's exact (M, N, K, spA, spB), with
sparsity in percent as the paper prints it; :data:`PAPER_LAYER_GROUPS`
groups them by the dataflow the paper finds friendliest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["LayerSpec", "PAPER_LAYERS", "PAPER_LAYER_GROUPS"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One GEMM layer: C[M,N] = A[M,K] @ B[K,N] with sparsity in percent."""

    name: str
    m: int
    n: int
    k: int
    sp_a: float          # % zeros in A (paper convention)
    sp_b: float
    model: str = ""

    @property
    def density_a(self) -> float:
        return max(0.0, 1.0 - self.sp_a / 100.0)

    @property
    def density_b(self) -> float:
        return max(0.0, 1.0 - self.sp_b / 100.0)


PAPER_LAYERS: Dict[str, LayerSpec] = {
    # name          M     N      K     spA  spB
    "SQ5":   LayerSpec("SQ5",   64, 2916,   16, 68, 11, model="squeezenet"),
    "SQ11":  LayerSpec("SQ11", 128,  729,   32, 70, 10, model="squeezenet"),
    "R4":    LayerSpec("R4",   256, 3136,   64, 88,  9, model="resnet50"),
    "R6":    LayerSpec("R6",    64, 2916,  576, 89, 53, model="resnet50"),
    "S-R3":  LayerSpec("S-R3",  64, 5329,  576, 89, 46, model="ssd_resnet"),
    "V0":    LayerSpec("V0",   128, 12100, 576, 90, 61, model="vgg16"),
    "MB215": LayerSpec("MB215", 128,    8,  512, 50,  0, model="mobilebert"),
    "V7":    LayerSpec("V7",   512,  144, 4608, 90, 94, model="vgg16"),
    "A2":    LayerSpec("A2",   384,  121, 1728, 70, 54, model="alexnet"),
}

#: Per Table 6, the paper groups these by friendliest dataflow.
PAPER_LAYER_GROUPS = {
    "ip": ("SQ5", "SQ11", "R4"),
    "op": ("R6", "S-R3", "V0"),
    "gust": ("MB215", "V7", "A2"),
}
