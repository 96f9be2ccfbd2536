"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` source of the checkout into one
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The library lands in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a digest of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as built. The build happens at
first use; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernels if this digest is not built yet. Returns the
    compiler's output (``-Xptxas -v`` register and shared-memory report;
    empty when the library was already built)."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            log, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return log


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    fn = lib.paged_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
