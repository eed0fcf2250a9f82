"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
``build/repro_torch_kernels/`` at the root of the checkout.  The library's
file name carries a hash of its source and flags, so an edited source
builds anew and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout
    (``src/repro_torch/kernels`` is three levels below it)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    compiler's output (the ``-Xptxas -v`` register and spill report, empty
    for a library built earlier); raises ``RuntimeError`` with that output
    if ``nvcc`` fails."""
    out = lib_path(name)
    if out.exists():
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                           "the CUDA kernels cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a file of this process, then rename: a concurrent build of
    # the same source never loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built first if it is
    missing."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
