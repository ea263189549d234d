"""DNN workloads for the paper's evaluation (Tables 2 and 6).

Two tiers:

- :data:`PAPER_LAYERS` — the nine representative layers of Table 6, exact
  (M, N, K, spA, spB).
- :func:`model_layers` — per-layer GEMM tables for the eight end-to-end DNN
  models of Table 2.  The paper does not publish per-layer dimensions, so the
  tables are reconstructed from the public architectures (conv layers as
  im2col GEMMs: A = weights (Cout × Cin·k²), B = activations (Cin·k² × H·W));
  per-layer sparsities are drawn deterministically around the Table 2 model
  averages, with the Table 6 layers pinned exactly at their indices (e.g.
  VGG layer 0 = V0, SqueezeNet layer 5 = SQ5, MobileBERT layer 215 = MB215).
  Layer counts match Table 2's ``nl`` column.

CPU MKL reference cycles (Table 2, last column) anchor the Fig. 12 speedups.
Every table is equal to the JAX package's ``repro.core.workloads``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .simulator.stats import LayerSpec

__all__ = ["LayerSpec", "PAPER_LAYERS", "PAPER_LAYER_GROUPS", "MODELS",
           "CPU_CYCLES_1E6", "model_layers", "TABLE2"]

# --------------------------------------------------------------------------
# Table 6 — nine representative layers (exact)
# --------------------------------------------------------------------------

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

# --------------------------------------------------------------------------
# Table 2 — the eight DNN models
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelInfo:
    name: str
    short: str
    domain: str
    nl: int
    av_sp_a: float
    av_sp_b: float
    cpu_cycles_1e6: float


TABLE2 = [
    ModelInfo("alexnet", "A", "CV", 7, 70, 48, 3804),
    ModelInfo("squeezenet", "S", "CV", 26, 70, 31, 2751),
    ModelInfo("vgg16", "V", "CV", 8, 90, 80, 6012),
    ModelInfo("resnet50", "R", "CV", 54, 89, 52, 4185),
    ModelInfo("ssd_resnet", "S-R", "OR", 37, 89, 49, 6429),
    ModelInfo("ssd_mobilenet", "S-M", "OR", 29, 74, 35, 5379),
    ModelInfo("distilbert", "DB", "NLP", 36, 50, 0.04, 5748),
    ModelInfo("mobilebert", "MB", "NLP", 316, 50, 11, 4893),
]

MODELS = {m.name: m for m in TABLE2}
CPU_CYCLES_1E6 = {m.name: m.cpu_cycles_1e6 for m in TABLE2}


def _conv(name, cout, cin, k, hout, model) -> Tuple[str, int, int, int]:
    return (name, cout, hout * hout, cin * k * k)


def _gemm(name, m, n, k) -> Tuple[str, int, int, int]:
    return (name, m, n, k)


def _alexnet() -> List[Tuple[str, int, int, int]]:
    return [
        _conv("conv1", 96, 3, 11, 55, "alexnet"),
        _conv("conv2", 256, 48, 5, 27, "alexnet"),
        _conv("conv3", 384, 192, 3, 11, "alexnet"),       # = A2
        _conv("conv4", 384, 192, 3, 11, "alexnet"),
        _conv("conv5", 256, 192, 3, 11, "alexnet"),
        _gemm("fc6", 4096, 1, 9216),
        _gemm("fc7", 4096, 1, 4096),
    ]


def _vgg16() -> List[Tuple[str, int, int, int]]:
    # The paper evaluates 8 representative GEMMs; V0 and V7 pinned.
    return [
        _conv("conv2_1", 128, 64, 3, 110, "vgg16"),        # = V0
        _conv("conv2_2", 128, 128, 3, 110, "vgg16"),
        _conv("conv3_1", 256, 128, 3, 55, "vgg16"),
        _conv("conv3_2", 256, 256, 3, 55, "vgg16"),
        _conv("conv4_1", 512, 256, 3, 27, "vgg16"),
        _conv("conv4_2", 512, 512, 3, 27, "vgg16"),
        _conv("conv5_1", 512, 512, 3, 13, "vgg16"),
        _conv("conv5_2", 512, 512, 3, 12, "vgg16"),        # = V7
    ]


def _squeezenet() -> List[Tuple[str, int, int, int]]:
    layers = [_conv("conv1", 96, 3, 7, 54, "s")]
    fires = [  # (squeeze, expand, hout)
        (16, 64, 54), (16, 64, 54), (32, 128, 54),
        (32, 128, 27), (48, 192, 27), (48, 192, 27),
        (64, 256, 27), (64, 256, 13),
    ]
    cin = 96
    for i, (s, e, h) in enumerate(fires, start=2):
        layers.append(_conv(f"fire{i}_s", s, cin, 1, h, "s"))
        layers.append(_conv(f"fire{i}_e1", e, s, 1, h, "s"))   # fire3_e1 = SQ5
        layers.append(_conv(f"fire{i}_e3", e, s, 3, h, "s"))
        cin = 2 * e
    layers.append(_conv("conv10", 1000, 512, 1, 13, "s"))
    return layers


def _resnet50() -> List[Tuple[str, int, int, int]]:
    layers = [_conv("conv1", 64, 3, 7, 109, "r")]
    stages = [  # (blocks, width, hout)
        (3, 64, 54), (4, 128, 27), (6, 256, 14), (3, 512, 7),
    ]
    cin = 64
    for si, (blocks, w, h) in enumerate(stages, start=1):
        for b in range(blocks):
            layers.append(_conv(f"s{si}b{b}_c1", w, cin, 1, h, "r"))
            layers.append(_conv(f"s{si}b{b}_c2", w, w, 3, h, "r"))
            layers.append(_conv(f"s{si}b{b}_c3", 4 * w, w, 1, h, "r"))
            if b == 0:
                layers.append(_conv(f"s{si}b{b}_proj", 4 * w, cin, 1, h, "r"))
            cin = 4 * w
    layers.append(_gemm("fc", 1000, 1, 2048))
    return layers


def _ssd_resnet() -> List[Tuple[str, int, int, int]]:
    # ResNet-34 backbone at 300x300 detection resolution + head convs.
    layers = [_conv("conv1", 64, 3, 7, 146, "sr")]
    stages = [(3, 64, 73), (4, 128, 37), (6, 256, 19), (3, 512, 10)]
    cin = 64
    for si, (blocks, w, h) in enumerate(stages, start=1):
        for b in range(blocks):
            layers.append(_conv(f"s{si}b{b}_c1", w, cin, 3, h, "sr"))
            layers.append(_conv(f"s{si}b{b}_c2", w, w, 3, h, "sr"))
            if b == 0 and si > 1:
                layers.append(_conv(f"s{si}b{b}_proj", w, cin, 1, h, "sr"))
            cin = w
    layers.append(_conv("head1", 324, 512, 3, 10, "sr"))
    layers.append(_conv("head2", 486, 512, 3, 5, "sr"))
    return layers[:37]


def _ssd_mobilenet() -> List[Tuple[str, int, int, int]]:
    # MobileNetV1 backbone: full conv + alternating dw/pw separable convs.
    cfg = [(64, 75), (128, 38), (128, 38), (256, 19), (256, 19), (512, 10),
           (512, 10), (512, 10), (512, 10), (512, 10), (1024, 5), (1024, 5)]
    layers = [_conv("conv0", 32, 3, 3, 75, "sm")]
    cin = 32
    for i, (cout, h) in enumerate(cfg):
        layers.append(_conv(f"dw{i}", cin, 1, 3, h, "sm"))     # depthwise
        layers.append(_conv(f"pw{i}", cout, cin, 1, h, "sm"))  # pointwise
        cin = cout
    layers.append(_conv("head1", 546, 1024, 3, 5, "sm"))
    layers.append(_conv("head2", 546, 512, 3, 3, "sm"))
    layers.append(_conv("head3", 546, 256, 3, 2, "sm"))
    layers.append(_conv("head4", 324, 256, 3, 1, "sm"))
    return layers[:29]


def _distilbert(seq: int = 128) -> List[Tuple[str, int, int, int]]:
    d, ff = 768, 3072
    layers = []
    for b in range(6):
        layers += [
            _gemm(f"b{b}_q", d, seq, d), _gemm(f"b{b}_k", d, seq, d),
            _gemm(f"b{b}_v", d, seq, d), _gemm(f"b{b}_o", d, seq, d),
            _gemm(f"b{b}_ff1", ff, seq, d), _gemm(f"b{b}_ff2", d, seq, ff),
        ]
    return layers


def _mobilebert(seq: int = 8) -> List[Tuple[str, int, int, int]]:
    # 24 blocks x 13 GEMMs + 4 embedding/pooler GEMMs = 316.
    # Bottleneck width 128, body 512, stacked FFNs (x4).
    layers: List[Tuple[str, int, int, int]] = []
    for b in range(24):
        layers += [
            _gemm(f"b{b}_in", 128, seq, 512),
            _gemm(f"b{b}_q", 128, seq, 128), _gemm(f"b{b}_k", 128, seq, 128),
            _gemm(f"b{b}_v", 128, seq, 128), _gemm(f"b{b}_o", 128, seq, 128),
        ]
        for f in range(4):
            layers += [
                _gemm(f"b{b}_ff{f}a", 512, seq, 128),
                _gemm(f"b{b}_ff{f}b", 128, seq, 512),   # b8_ff1b == MB215
            ]
    layers += [
        _gemm("embed_proj", 512, seq, 128), _gemm("pool", 512, 1, 512),
        _gemm("cls1", 512, seq, 512), _gemm("cls2", 128, seq, 512),
    ]
    return layers


_GENERATORS = {
    "alexnet": _alexnet,
    "squeezenet": _squeezenet,
    "vgg16": _vgg16,
    "resnet50": _resnet50,
    "ssd_resnet": _ssd_resnet,
    "ssd_mobilenet": _ssd_mobilenet,
    "distilbert": _distilbert,
    "mobilebert": _mobilebert,
}

# Table 6 layers pinned at their model indices: model -> {index: layer name}
_PINNED = {
    "squeezenet": {5: "SQ5", 11: "SQ11"},
    "resnet50": {4: "R4", 6: "R6"},
    "ssd_resnet": {3: "S-R3"},
    "vgg16": {0: "V0", 7: "V7"},
    "mobilebert": {215: "MB215"},
    "alexnet": {2: "A2"},
}


def model_layers(model: str, seed: int = 0) -> List[LayerSpec]:
    """Per-layer specs for one Table 2 model (deterministic)."""
    info = MODELS[model]
    dims = _GENERATORS[model]()
    if len(dims) != info.nl:
        raise AssertionError(
            f"{model}: generated {len(dims)} layers, Table 2 says {info.nl}")
    # stable across processes (Python's str hash is PYTHONHASHSEED-random)
    import zlib
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(model.encode())]))
    pinned = _PINNED.get(model, {})
    out: List[LayerSpec] = []
    for i, (name, m, n, k) in enumerate(dims):
        if i in pinned:
            p = PAPER_LAYERS[pinned[i]]
            out.append(dataclasses.replace(p, model=model))
            continue
        # per-layer sparsity jitter around the Table 2 model average
        sp_a = float(np.clip(info.av_sp_a + rng.normal(0, 6), 0, 98))
        sp_b = float(np.clip(info.av_sp_b + rng.normal(0, 8), 0, 98))
        out.append(LayerSpec(f"{info.short}{i}", m, n, k, sp_a, sp_b,
                             model=model))
    return out
