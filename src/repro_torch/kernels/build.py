"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source in ``repro_torch/csrc/`` compiles with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface.  The library's file name
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads from the build directory (``repro_torch/_build``,
listed in ``.gitignore``).

Nothing here runs at import time: the CPU tests import every module, and
this machine need not have ``nvcc``.  A failed build raises; no caller
falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["SOURCES", "build", "library", "nvcc"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: library name -> source file under ``csrc/``
SOURCES = {"stream_spmm": "stream_spmm.cu", "moe_gmm": "moe_gmm.cu",
           "attention": "attention.cu"}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: on ``PATH``, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc is neither on PATH nor at "
            f"{path}")
    return path


def build(name: str) -> Tuple[Path, str]:
    """Compile library ``name`` unless its hash-named file exists.

    Returns the library's path and ``nvcc``'s output (empty when it was
    already built).  Raises ``RuntimeError`` with that output on failure.
    """
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # written under a private name, then renamed: a process that finds the
    # library never finds it half written
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,  # lint: host build
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return out, proc.stdout


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        _LIBS[name] = lib
    return lib
